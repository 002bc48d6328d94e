"""EVM verifier generation: emit a standalone Yul contract that verifies
this stack's PLONK proofs on-chain.

Twin of the reference's snark-verifier-based generator
(``eigentrust-zk/src/verifier/mod.rs``: ``gen_evm_verifier_code``
:116-145 emits Yul from a vk, ``encode_calldata`` :41-56 packs
instances‖proof, ``evm_verify`` :148-168 runs the contract in an
in-memory EVM and reports gas). Here the verifier is generated directly
from the vk: the full ``plonk.succinct_verify`` algebra — Poseidon
transcript, gate/permutation/LogUp identities, batched-KZG fold — plus
the final pairing via the EVM precompiles (0x06 ecAdd, 0x07 ecMul,
0x08 ecPairing, 0x05 modexp for field inversions). ``evm_verify``
executes the generated Yul with the in-repo interpreter (``zk/yul.py``)
— no EVM dependency — and returns the estimated gas.

Note the transcript is Poseidon (protocol parity with the in-circuit
aggregator) rather than keccak, so on-chain gas is dominated by the
~35 sponge permutations; the number is reported, not optimized.
"""

from __future__ import annotations

from ..crypto.poseidon import poseidon_params
from ..utils.errors import EigenError
from ..utils.fields import BN254_FR_MODULUS as R
from .bn254 import BN254_FQ_MODULUS as Q
from .bn254 import G2_GEN
from .domain import EvaluationDomain
from .kzg import KZGParams
from .plonk import (FIXED_NAMES, NUM_PERM_PARTIALS, NUM_WIRES,
                    QUOTIENT_CHUNKS)
from .yul import VMRevert, YulVM

from .transcript import TRANSCRIPT_LABEL

# transcript label seed (PoseidonTranscript's default label)
_LABEL_SEED = int.from_bytes(TRANSCRIPT_LABEL, "little") % R

# wires, m, z, phi, z-split partials (u1 u2 v1 v2), t chunks
_NPTS = NUM_WIRES + 3 + NUM_PERM_PARTIALS + QUOTIENT_CHUNKS
_NEVALS = (NUM_WIRES + 5 + NUM_PERM_PARTIALS + QUOTIENT_CHUNKS
           + len(FIXED_NAMES) + NUM_WIRES)

# memory map (bytes)
_RC = 0x2000  # poseidon round constants
_MDS = 0x5000
_WTAB = 0x5400  # omega^row per public row
_VKTAB = 0x5800  # vk commitments (x, y pairs)
_SHIFTS = 0x6000  # permutation coset shifts
_FVTAB = 0x7000  # z-split X-side wire factors fv[w] (6 words)
_GVTAB = 0x7100  # z-split σ-side wire factors gv[w] (6 words)
_STATE = 0x200  # sponge state (5 words)
_SPCOUNT = 0x2A0
_ROUNDS = 0x2C0
_BUF = 0x300  # sponge buffer (fits (RC-BUF)/32 = 232 entries)

# eval-word indices within the proof's evaluation section
_EV_M = NUM_WIRES
_EV_Z = NUM_WIRES + 1
_EV_ZN = NUM_WIRES + 2
_EV_PHI = NUM_WIRES + 3
_EV_PHIN = NUM_WIRES + 4
_EV_UV = NUM_WIRES + 5  # u1, u2, v1, v2
_EV_T = _EV_UV + NUM_PERM_PARTIALS
_EV_FIXED = _EV_T + QUOTIENT_CHUNKS
_EV_SIGMA = _EV_FIXED + len(FIXED_NAMES)
# proof-point index of the first z-split partial / first t chunk
_PT_UV = NUM_WIRES + 3
_PT_T = _PT_UV + NUM_PERM_PARTIALS


def proof_layout(num_instances: int) -> dict:
    """Calldata word offsets: instances ‖ 16 points ‖ 33 evals ‖ W, W'."""
    pts = num_instances
    evals = pts + 2 * _NPTS
    w = evals + _NEVALS
    return {"pts": pts, "evals": evals, "w": w, "total_words": w + 4}


def encode_calldata(instances: list, proof_bytes: bytes) -> bytes:
    """instances ‖ proof as 32-byte big-endian calldata words
    (verifier/mod.rs:41-56). Proof points are already BE; evaluation
    words are LE in the native proof encoding and flip here."""
    expected = 64 * _NPTS + 32 * _NEVALS + 128
    if len(proof_bytes) != expected:
        raise EigenError("parsing_error",
                         f"proof must be {expected} bytes, got {len(proof_bytes)}")
    out = [int(v).to_bytes(32, "big") for v in instances]
    out.append(proof_bytes[: 64 * _NPTS])
    evals = proof_bytes[64 * _NPTS : 64 * _NPTS + 32 * _NEVALS]
    for i in range(_NEVALS):
        out.append(evals[32 * i : 32 * (i + 1)][::-1])
    out.append(proof_bytes[-128:])
    return b"".join(out)


def _hx(v: int) -> str:
    return hex(int(v))


def gen_evm_verifier_code(params: KZGParams, vk,
                          transcript: str = "poseidon") -> str:
    """Generate the Yul verifier for a verifying key (any of
    ProvingKey / FastProvingKey / VerifyingKey: needs ``k``, ``shifts``,
    ``public_rows``, ``commit_list()``) and the SRS tau point.

    ``transcript="keccak"`` emits the on-chain-cheap variant (the
    reference's snark-verifier shape, verifier/mod.rs:116-145): one
    keccak256 per challenge instead of Poseidon permutations — it
    verifies proofs produced with ``prove(..., transcript="keccak")``.
    "poseidon" keeps protocol parity with the in-circuit aggregator."""
    n_pub = len(vk.public_rows)
    layout = proof_layout(n_pub)
    if _BUF + 32 * (n_pub + 64) > _RC:
        raise EigenError("circuit_error",
                         "too many public inputs for the sponge buffer region")
    d = EvaluationDomain(vk.k)
    rc, mds, full_rounds, partial_rounds = poseidon_params()
    half = full_rounds // 2

    def off(word_index: int) -> str:
        return _hx(32 * word_index)

    def pt_x(i: int) -> str:  # calldata x-coordinate of proof point i
        return f"calldataload({off(layout['pts'] + 2 * i)})"

    def pt_y(i: int) -> str:
        return f"calldataload({off(layout['pts'] + 2 * i + 1)})"

    def ev(j: int) -> str:
        return f"calldataload({off(layout['evals'] + j)})"

    lines: list = []
    emit = lines.append

    # --- constant tables (Poseidon round constants only when used) --------
    if transcript == "poseidon":
        for i, c in enumerate(rc):
            emit(f"mstore({_hx(_RC + 32 * i)}, {_hx(c)})")
        for i in range(5):
            for j in range(5):
                emit(f"mstore({_hx(_MDS + 32 * (5 * i + j))}, "
                     f"{_hx(mds[i][j])})")
    else:
        from ..utils.keccak import keccak256 as _k

        seed = int.from_bytes(_k(TRANSCRIPT_LABEL), "big")
        emit(f"mstore({_hx(_STATE)}, {_hx(seed)})")
    for i, row in enumerate(vk.public_rows):
        emit(f"mstore({_hx(_WTAB + 32 * i)}, {_hx(pow(d.omega, row, R))})")
    commits = vk.commit_list()
    for i, pt in enumerate(commits):
        x, y = (0, 0) if pt is None else pt
        emit(f"mstore({_hx(_VKTAB + 64 * i)}, {_hx(x)})")
        emit(f"mstore({_hx(_VKTAB + 64 * i + 32)}, {_hx(y)})")
    for w, s in enumerate(vk.shifts):
        emit(f"mstore({_hx(_SHIFTS + 32 * w)}, {_hx(s)})")
    preamble = "\n      ".join(lines)

    # --- poseidon permutation rounds (loops over the constant table) -----
    def full_round_block(count: int) -> str:
        return f"""
        for {{ let r := 0 }} lt(r, {count}) {{ r := add(r, 1) }} {{
          s0 := pow5(addmod(s0, mload(idx), RMOD))
          s1 := pow5(addmod(s1, mload(add(idx, 32)), RMOD))
          s2 := pow5(addmod(s2, mload(add(idx, 64)), RMOD))
          s3 := pow5(addmod(s3, mload(add(idx, 96)), RMOD))
          s4 := pow5(addmod(s4, mload(add(idx, 128)), RMOD))
          idx := add(idx, 160)
          s0, s1, s2, s3, s4 := mds(s0, s1, s2, s3, s4)
        }}"""

    # --- group-1 fold items: (x_expr, y_expr, eval_expr) ------------------
    fold_items = []
    for w in range(NUM_WIRES):
        fold_items.append((pt_x(w), pt_y(w), ev(w)))
    fold_items.append((pt_x(NUM_WIRES), pt_y(NUM_WIRES), ev(_EV_M)))
    fold_items.append((pt_x(NUM_WIRES + 1), pt_y(NUM_WIRES + 1), ev(_EV_Z)))
    fold_items.append((pt_x(NUM_WIRES + 2), pt_y(NUM_WIRES + 2), ev(_EV_PHI)))
    for i in range(NUM_PERM_PARTIALS):
        fold_items.append((pt_x(_PT_UV + i), pt_y(_PT_UV + i),
                           ev(_EV_UV + i)))
    for c in range(QUOTIENT_CHUNKS):
        fold_items.append((pt_x(_PT_T + c), pt_y(_PT_T + c),
                           ev(_EV_T + c)))
    for i in range(len(commits)):
        fold_items.append((f"mload({_hx(_VKTAB + 64 * i)})",
                           f"mload({_hx(_VKTAB + 64 * i + 32)})",
                           ev(_EV_FIXED + i)))
    fold_code = []
    for x_expr, y_expr, e_expr in fold_items:
        fold_code.append(f"""
      tx, ty := ec_mul({x_expr}, {y_expr}, g)
      fx, fy := ec_add(fx, fy, tx, ty)
      yf := addmod(yf, mulmod(g, {e_expr}, RMOD), RMOD)
      g := mulmod(g, v_ch, RMOD)""")
    fold_body = "".join(fold_code)

    # gate identity operands
    a, b, c_, dd, e_ = (ev(i) for i in range(5))
    q = {name: ev(_EV_FIXED + i) for i, name in enumerate(FIXED_NAMES)}

    if transcript == "poseidon":
        sponge_fns = f"""      function pow5(x) -> y {{
        let x2 := mulmod(x, x, {_hx(R)})
        let x4 := mulmod(x2, x2, {_hx(R)})
        y := mulmod(x4, x, {_hx(R)})
      }}
      function mds(s0, s1, s2, s3, s4) -> o0, o1, o2, o3, o4 {{
        let RM := {_hx(R)}
        o0 := addmod(addmod(addmod(mulmod(mload({_hx(_MDS)}), s0, RM), mulmod(mload({_hx(_MDS + 32)}), s1, RM), RM), addmod(mulmod(mload({_hx(_MDS + 64)}), s2, RM), mulmod(mload({_hx(_MDS + 96)}), s3, RM), RM), RM), mulmod(mload({_hx(_MDS + 128)}), s4, RM), RM)
        o1 := addmod(addmod(addmod(mulmod(mload({_hx(_MDS + 160)}), s0, RM), mulmod(mload({_hx(_MDS + 192)}), s1, RM), RM), addmod(mulmod(mload({_hx(_MDS + 224)}), s2, RM), mulmod(mload({_hx(_MDS + 256)}), s3, RM), RM), RM), mulmod(mload({_hx(_MDS + 288)}), s4, RM), RM)
        o2 := addmod(addmod(addmod(mulmod(mload({_hx(_MDS + 320)}), s0, RM), mulmod(mload({_hx(_MDS + 352)}), s1, RM), RM), addmod(mulmod(mload({_hx(_MDS + 384)}), s2, RM), mulmod(mload({_hx(_MDS + 416)}), s3, RM), RM), RM), mulmod(mload({_hx(_MDS + 448)}), s4, RM), RM)
        o3 := addmod(addmod(addmod(mulmod(mload({_hx(_MDS + 480)}), s0, RM), mulmod(mload({_hx(_MDS + 512)}), s1, RM), RM), addmod(mulmod(mload({_hx(_MDS + 544)}), s2, RM), mulmod(mload({_hx(_MDS + 576)}), s3, RM), RM), RM), mulmod(mload({_hx(_MDS + 608)}), s4, RM), RM)
        o4 := addmod(addmod(addmod(mulmod(mload({_hx(_MDS + 640)}), s0, RM), mulmod(mload({_hx(_MDS + 672)}), s1, RM), RM), addmod(mulmod(mload({_hx(_MDS + 704)}), s2, RM), mulmod(mload({_hx(_MDS + 736)}), s3, RM), RM), RM), mulmod(mload({_hx(_MDS + 768)}), s4, RM), RM)
      }}
      function permute() {{
        let RMOD := {_hx(R)}
        let s0 := mload({_hx(_STATE)})
        let s1 := mload({_hx(_STATE + 32)})
        let s2 := mload({_hx(_STATE + 64)})
        let s3 := mload({_hx(_STATE + 96)})
        let s4 := mload({_hx(_STATE + 128)})
        let idx := {_hx(_RC)}
        {full_round_block(half)}
        for {{ let r := 0 }} lt(r, {partial_rounds}) {{ r := add(r, 1) }} {{
          s0 := pow5(addmod(s0, mload(idx), RMOD))
          s1 := addmod(s1, mload(add(idx, 32)), RMOD)
          s2 := addmod(s2, mload(add(idx, 64)), RMOD)
          s3 := addmod(s3, mload(add(idx, 96)), RMOD)
          s4 := addmod(s4, mload(add(idx, 128)), RMOD)
          idx := add(idx, 160)
          s0, s1, s2, s3, s4 := mds(s0, s1, s2, s3, s4)
        }}
        {full_round_block(half)}
        mstore({_hx(_STATE)}, s0)
        mstore({_hx(_STATE + 32)}, s1)
        mstore({_hx(_STATE + 64)}, s2)
        mstore({_hx(_STATE + 96)}, s3)
        mstore({_hx(_STATE + 128)}, s4)
      }}
      function sp_push(v) {{
        let cnt := mload({_hx(_SPCOUNT)})
        mstore(add({_hx(_BUF)}, mul(cnt, 32)), v)
        mstore({_hx(_SPCOUNT)}, add(cnt, 1))
      }}
      function sp_squeeze() -> out {{
        let cnt := mload({_hx(_SPCOUNT)})
        if iszero(cnt) {{ mstore({_hx(_BUF)}, 0) cnt := 1 }}
        for {{ let start := 0 }} lt(start, cnt) {{ start := add(start, 5) }} {{
          for {{ let i := 0 }} lt(i, 5) {{ i := add(i, 1) }} {{
            let j := add(start, i)
            if lt(j, cnt) {{
              let slot := add({_hx(_STATE)}, mul(i, 32))
              mstore(slot, addmod(mload(slot), mload(add({_hx(_BUF)}, mul(j, 32))), {_hx(R)}))
            }}
          }}
          permute()
        }}
        mstore({_hx(_SPCOUNT)}, 0)
        out := mload({_hx(_STATE)})
      }}
      function challenge() -> c {{
        let r := add(mload({_hx(_ROUNDS)}), 1)
        mstore({_hx(_ROUNDS)}, r)
        sp_push(r)
        c := sp_squeeze()
      }}
      function absorb_pt(x, y) {{
        switch and(iszero(x), iszero(y))
        case 1 {{
          sp_push(1) sp_push(0) sp_push(0) sp_push(0) sp_push(0)
        }}
        default {{
          sp_push(2)
          sp_push(and(x, {_hx((1 << 128) - 1)}))
          sp_push(shr(128, x))
          sp_push(and(y, {_hx((1 << 128) - 1)}))
          sp_push(shr(128, y))
        }}
      }}"""
    else:
        sponge_fns = f"""
      function sp_push(v) {{
        let cnt := mload({_hx(0x1c0)})
        mstore(add({_hx(_STATE + 32)}, mul(cnt, 32)), v)
        mstore({_hx(0x1c0)}, add(cnt, 1))
      }}
      function absorb_pt(x, y) {{
        sp_push(x)
        sp_push(y)
      }}
      function challenge() -> c {{
        let r := add(mload({_hx(0x1e0)}), 1)
        mstore({_hx(0x1e0)}, r)
        let cnt := mload({_hx(0x1c0)})
        mstore(add({_hx(_STATE + 32)}, mul(cnt, 32)), r)
        let h := keccak256({_hx(_STATE)}, mul(add(cnt, 2), 32))
        mstore({_hx(_STATE)}, h)
        mstore({_hx(0x1c0)}, 0)
        c := mod(h, {_hx(R)})
      }}"""
    label_init = (f"sp_push({_hx(_LABEL_SEED)})"
                  if transcript == "poseidon" else "")
    code = f"""
object "PlonkVerifier" {{
  code {{
    datacopy(0, dataoffset("runtime"), datasize("runtime"))
    return(0, datasize("runtime"))
  }}
  object "runtime" {{
    code {{
      // ---- generated for vk: k={vk.k}, {n_pub} public inputs ----
      let RMOD := {_hx(R)}
      let QMOD := {_hx(Q)}
      let NDOM := {_hx(1 << vk.k)}
      let OMEGA := {_hx(d.omega)}

{sponge_fns}
      function check_point(x, y) {{
        if and(iszero(x), iszero(y)) {{ leave }}
        if iszero(and(lt(x, {_hx(Q)}), lt(y, {_hx(Q)}))) {{ revert(0, 0) }}
        if iszero(eq(mulmod(y, y, {_hx(Q)}), addmod(mulmod(mulmod(x, x, {_hx(Q)}), x, {_hx(Q)}), 3, {_hx(Q)}))) {{ revert(0, 0) }}
      }}
      function expmod(base, exponent) -> r {{
        mstore(0, 32) mstore(32, 32) mstore(64, 32)
        mstore(96, base) mstore(128, exponent) mstore(160, {_hx(R)})
        if iszero(staticcall(gas(), 5, 0, 192, 0, 32)) {{ revert(0, 0) }}
        r := mload(0)
      }}
      function f_inv(x) -> r {{
        r := expmod(x, {_hx(R - 2)})
      }}
      function submod(a, b) -> r {{
        r := addmod(a, sub({_hx(R)}, b), {_hx(R)})
      }}
      function ec_mul(x, y, s) -> rx, ry {{
        mstore(0, x) mstore(32, y) mstore(64, s)
        if iszero(staticcall(gas(), 7, 0, 96, 0, 64)) {{ revert(0, 0) }}
        rx := mload(0)
        ry := mload(32)
      }}
      function ec_add(ax, ay, bx, by) -> rx, ry {{
        mstore(0, ax) mstore(32, ay) mstore(64, bx) mstore(96, by)
        if iszero(staticcall(gas(), 6, 0, 128, 0, 64)) {{ revert(0, 0) }}
        rx := mload(0)
        ry := mload(32)
      }}

      // ---- calldata shape ----
      if iszero(eq(calldatasize(), {_hx(32 * layout['total_words'])})) {{ revert(0, 0) }}

      // ---- constant tables ----
      {preamble}

      // ---- transcript: label, instances, commitments ----
      {label_init}
      for {{ let i := 0 }} lt(i, {n_pub}) {{ i := add(i, 1) }} {{
        let v := calldataload(mul(i, 32))
        if iszero(lt(v, RMOD)) {{ revert(0, 0) }}
        sp_push(v)
      }}
      for {{ let i := 0 }} lt(i, {_NPTS}) {{ i := add(i, 1) }} {{
        let po := add({off(layout['pts'])}, mul(i, 64))
        check_point(calldataload(po), calldataload(add(po, 32)))
      }}
      check_point(calldataload({off(layout['w'])}), calldataload({off(layout['w'] + 1)}))
      check_point(calldataload({off(layout['w'] + 2)}), calldataload({off(layout['w'] + 3)}))
      for {{ let i := 0 }} lt(i, {NUM_WIRES + 1}) {{ i := add(i, 1) }} {{
        let po := add({off(layout['pts'])}, mul(i, 64))
        absorb_pt(calldataload(po), calldataload(add(po, 32)))
      }}
      let beta := challenge()
      let gamma := challenge()
      let beta_lk := challenge()
      for {{ let i := {NUM_WIRES + 1} }} lt(i, {_PT_T}) {{ i := add(i, 1) }} {{
        let po := add({off(layout['pts'])}, mul(i, 64))
        absorb_pt(calldataload(po), calldataload(add(po, 32)))
      }}
      let alpha := challenge()
      for {{ let i := {_PT_T} }} lt(i, {_NPTS}) {{ i := add(i, 1) }} {{
        let po := add({off(layout['pts'])}, mul(i, 64))
        absorb_pt(calldataload(po), calldataload(add(po, 32)))
      }}
      let zeta := challenge()
      for {{ let i := 0 }} lt(i, {_NEVALS}) {{ i := add(i, 1) }} {{
        let v := calldataload(add({off(layout['evals'])}, mul(i, 32)))
        if iszero(lt(v, RMOD)) {{ revert(0, 0) }}
        sp_push(v)
      }}
      let v_ch := challenge()
      let u_ch := challenge()

      // ---- vanishing + public-input polynomial ----
      let zh := submod(expmod(zeta, NDOM), 1)
      if iszero(zh) {{ revert(0, 0) }}
      let pi := 0
      for {{ let i := 0 }} lt(i, {n_pub}) {{ i := add(i, 1) }} {{
        let wi := mload(add({_hx(_WTAB)}, mul(i, 32)))
        let li := mulmod(wi, mulmod(zh, f_inv(mulmod(NDOM, submod(zeta, wi), RMOD)), RMOD), RMOD)
        pi := submod(pi, mulmod(calldataload(mul(i, 32)), li, RMOD))
      }}

      // ---- gate identity ----
      let gate := addmod(pi, {q['q_const']}, RMOD)
      gate := addmod(gate, mulmod({q['q_a']}, {a}, RMOD), RMOD)
      gate := addmod(gate, mulmod({q['q_b']}, {b}, RMOD), RMOD)
      gate := addmod(gate, mulmod({q['q_c']}, {c_}, RMOD), RMOD)
      gate := addmod(gate, mulmod({q['q_d']}, {dd}, RMOD), RMOD)
      gate := addmod(gate, mulmod({q['q_e']}, {e_}, RMOD), RMOD)
      gate := addmod(gate, mulmod({q['q_mul_ab']}, mulmod({a}, {b}, RMOD), RMOD), RMOD)
      gate := addmod(gate, mulmod({q['q_mul_cd']}, mulmod({c_}, {dd}, RMOD), RMOD), RMOD)

      // ---- z-split permutation constraints ----
      // wire factors fv[w] = w + β·k_w·ζ + γ, gv[w] = w + β·σ_w + γ
      // stored at scratch 0x7000 (fv) / 0x7100 (gv)
      for {{ let w := 0 }} lt(w, {NUM_WIRES}) {{ w := add(w, 1) }} {{
        let wv := calldataload(add({off(layout['evals'])}, mul(w, 32)))
        let shift := mload(add({_hx(_SHIFTS)}, mul(w, 32)))
        let sg := calldataload(add({off(layout['evals'] + _EV_SIGMA)}, mul(w, 32)))
        mstore(add({_hx(_FVTAB)}, mul(w, 32)), addmod(wv, addmod(mulmod(beta, mulmod(shift, zeta, RMOD), RMOD), gamma, RMOD), RMOD))
        mstore(add({_hx(_GVTAB)}, mul(w, 32)), addmod(wv, addmod(mulmod(beta, sg, RMOD), gamma, RMOD), RMOD))
      }}
      let u1 := {ev(_EV_UV)}
      let u2 := {ev(_EV_UV + 1)}
      let vv1 := {ev(_EV_UV + 2)}
      let vv2 := {ev(_EV_UV + 3)}
      let link := submod(
        mulmod(mulmod(u2, mload({_hx(_FVTAB + 128)}), RMOD), mload({_hx(_FVTAB + 160)}), RMOD),
        mulmod(mulmod(vv2, mload({_hx(_GVTAB + 128)}), RMOD), mload({_hx(_GVTAB + 160)}), RMOD))
      let c_u1 := submod(u1, mulmod(mulmod({ev(_EV_Z)}, mload({_hx(_FVTAB)}), RMOD), mload({_hx(_FVTAB + 32)}), RMOD))
      let c_u2 := submod(u2, mulmod(mulmod(u1, mload({_hx(_FVTAB + 64)}), RMOD), mload({_hx(_FVTAB + 96)}), RMOD))
      let c_v1 := submod(vv1, mulmod(mulmod({ev(_EV_ZN)}, mload({_hx(_GVTAB)}), RMOD), mload({_hx(_GVTAB + 32)}), RMOD))
      let c_v2 := submod(vv2, mulmod(mulmod(vv1, mload({_hx(_GVTAB + 64)}), RMOD), mload({_hx(_GVTAB + 96)}), RMOD))
      let l0 := mulmod(zh, f_inv(mulmod(NDOM, submod(zeta, 1), RMOD)), RMOD)

      // ---- LogUp lookup identity ----
      let ba := addmod(beta_lk, {ev(NUM_WIRES - 1)}, RMOD)
      let bt := addmod(beta_lk, {q['t_lookup']}, RMOD)
      let lk := submod(mulmod(mulmod(submod({ev(_EV_PHIN)}, {ev(_EV_PHI)}), ba, RMOD), bt, RMOD), bt)
      lk := addmod(lk, mulmod({ev(_EV_M)}, ba, RMOD), RMOD)

      // ---- total vs quotient ----
      let a2 := mulmod(alpha, alpha, RMOD)
      let a4 := mulmod(a2, a2, RMOD)
      let total := addmod(gate, mulmod(alpha, link, RMOD), RMOD)
      total := addmod(total, mulmod(a2, mulmod(l0, submod({ev(_EV_Z)}, 1), RMOD), RMOD), RMOD)
      total := addmod(total, mulmod(mulmod(a2, alpha, RMOD), lk, RMOD), RMOD)
      total := addmod(total, mulmod(a4, mulmod(l0, {ev(_EV_PHI)}, RMOD), RMOD), RMOD)
      total := addmod(total, mulmod(mulmod(a4, alpha, RMOD), c_u1, RMOD), RMOD)
      total := addmod(total, mulmod(mulmod(a4, a2, RMOD), c_u2, RMOD), RMOD)
      total := addmod(total, mulmod(mulmod(a4, mulmod(a2, alpha, RMOD), RMOD), c_v1, RMOD), RMOD)
      total := addmod(total, mulmod(mulmod(a4, a4, RMOD), c_v2, RMOD), RMOD)
      let zn := expmod(zeta, NDOM)
      let tz := 0
      let zacc := 1
      for {{ let i := 0 }} lt(i, {QUOTIENT_CHUNKS}) {{ i := add(i, 1) }} {{
        tz := addmod(tz, mulmod(calldataload(add({off(layout['evals'] + _EV_T)}, mul(i, 32))), zacc, RMOD), RMOD)
        zacc := mulmod(zacc, zn, RMOD)
      }}
      if iszero(eq(total, mulmod(zh, tz, RMOD))) {{ revert(0, 0) }}

      // ---- batched KZG fold (fold_batch, kzg.py) ----
      let fx := 0
      let fy := 0
      let yf := 0
      let g := 1
      let tx := 0
      let ty := 0{fold_body}
      let wx_x := calldataload({off(layout['w'])})
      let wx_y := calldataload({off(layout['w'] + 1)})
      let wwx_x := calldataload({off(layout['w'] + 2)})
      let wwx_y := calldataload({off(layout['w'] + 3)})
      tx, ty := ec_mul(1, 2, submod(0, yf))
      fx, fy := ec_add(fx, fy, tx, ty)
      tx, ty := ec_mul(wx_x, wx_y, zeta)
      let t1x, t1y := ec_add(fx, fy, tx, ty)

      let f2x := {pt_x(NUM_WIRES + 1)}
      let f2y := {pt_y(NUM_WIRES + 1)}
      tx, ty := ec_mul({pt_x(NUM_WIRES + 2)}, {pt_y(NUM_WIRES + 2)}, v_ch)
      f2x, f2y := ec_add(f2x, f2y, tx, ty)
      let y2 := addmod({ev(_EV_ZN)}, mulmod(v_ch, {ev(_EV_PHIN)}, RMOD), RMOD)
      tx, ty := ec_mul(1, 2, submod(0, y2))
      f2x, f2y := ec_add(f2x, f2y, tx, ty)
      tx, ty := ec_mul(wwx_x, wwx_y, mulmod(zeta, OMEGA, RMOD))
      let t2x, t2y := ec_add(f2x, f2y, tx, ty)

      tx, ty := ec_mul(t2x, t2y, u_ch)
      let accl_x, accl_y := ec_add(t1x, t1y, tx, ty)
      tx, ty := ec_mul(wwx_x, wwx_y, u_ch)
      let accr_x, accr_y := ec_add(wx_x, wx_y, tx, ty)

      // ---- deferred pairing: e(acc_l, G2)·e(−acc_r, τG2) == 1 ----
      mstore(0, accl_x)
      mstore(32, accl_y)
      mstore(64, {_hx(G2_GEN[0][1])})
      mstore(96, {_hx(G2_GEN[0][0])})
      mstore(128, {_hx(G2_GEN[1][1])})
      mstore(160, {_hx(G2_GEN[1][0])})
      mstore(192, accr_x)
      mstore(224, mod(sub({_hx(Q)}, accr_y), {_hx(Q)}))
      mstore(256, {_hx(params.s_g2[0][1])})
      mstore(288, {_hx(params.s_g2[0][0])})
      mstore(320, {_hx(params.s_g2[1][1])})
      mstore(352, {_hx(params.s_g2[1][0])})
      if iszero(staticcall(gas(), 8, 0, 384, 0, 32)) {{ revert(0, 0) }}
      if iszero(mload(0)) {{ revert(0, 0) }}
      mstore(0, 1)
      return(0, 32)
    }}
  }}
}}
"""
    return code


def evm_verify(code: str, calldata: bytes) -> tuple:
    """Execute the generated verifier. Returns (accepted, gas_estimate)
    — the reference's ``evm_verify`` shape (verifier/mod.rs:148-168),
    with gas from the interpreter's cost model."""
    vm = YulVM(code)
    try:
        out, gas = vm.run(calldata)
    except VMRevert:
        return False, vm.gas
    return len(out) == 32 and int.from_bytes(out, "big") == 1, gas
