"""Minimal Yul interpreter: executes the generated PLONK verifier
(``zk/evm.py``) against calldata, with EVM-style gas accounting.

The reference compiles its generated Yul verifier and runs it in an
in-memory EVM to check proofs and measure gas
(``eigentrust-zk/src/verifier/mod.rs:148-168``). This repo has no EVM
dependency, so the same closed loop is built from two artifacts that
share one source of truth: ``gen_evm_verifier_code`` emits Yul text, and
this module executes that text directly. Codegen bugs therefore surface
as verification failures in-repo, not on-chain.

Supported subset (everything the generator emits):

- statements: ``let``, assignment (``:=``), ``if``, ``switch``/``case``/
  ``default``, ``for``, blocks, function definitions (multi-return),
  ``break``/``continue``/``leave``, expression statements;
- expressions: decimal/hex literals, identifiers, builtin/user calls;
- builtins: 256-bit ``add sub mul div mod addmod mulmod exp lt gt eq
  iszero and or xor not shl shr``, ``mload mstore calldataload
  calldatasize staticcall revert return stop pop``;
- ``keccak256(offset, size)`` with the yellow-paper gas schedule
  (30 + 6/word) — the keccak-transcript verifier's workhorse;
- precompiles via ``staticcall``: 0x05 modexp (fixed 32/32/32 layout),
  0x06 ecAdd, 0x07 ecMul, 0x08 ecPairing (BN254).

Gas follows the yellow-paper / post-Berlin schedule, replayed during
execution (not a per-op estimate):

- quadratic memory expansion C_mem(a) = 3a + ⌊a²/512⌋ charged at every
  memory touch (mload/mstore/keccak/staticcall/return/revert ranges);
- dynamic ``exp`` (10 + 50/exponent-byte, EIP-160), EIP-2565 modexp,
  EIP-196/197 Istanbul curve-precompile prices, warm-account
  ``staticcall`` base (precompiles are warm by definition, EIP-2929);
- the transaction view adds the 21000 intrinsic cost plus EIP-2028
  calldata pricing (4/zero byte, 16/nonzero byte) — ``run_tx``;
- stack scheduling (the one thing an AST walker cannot see) is modeled
  explicitly: every literal/variable operand load charges 3 gas (PUSH/
  DUP), every assignment 3 (SWAP), every user call 11 (JUMP + JUMPDEST
  + return-jump) — calibrated against solc-compiled verifier gas
  shapes; see ``tests/test_evm_verifier.py`` for the hand-derived
  yellow-paper fixture that pins the schedule itself.
"""

from __future__ import annotations

import re

from ..utils.errors import EigenError

WORD = (1 << 256) - 1

# yellow-paper per-opcode costs (Appendix G: W_verylow=3, W_low=5,
# W_mid=8, W_base=2; keccak/exp/memory dynamics charged in _builtin)
GAS = {
    "add": 3, "sub": 3, "mul": 5, "div": 5, "mod": 5,
    "addmod": 8, "mulmod": 8, "exp": 10,
    "lt": 3, "gt": 3, "eq": 3, "iszero": 3,
    "and": 3, "or": 3, "xor": 3, "not": 3, "shl": 3, "shr": 3,
    "mload": 3, "mstore": 3, "calldataload": 3, "calldatasize": 2,
    "pop": 2, "gas": 2, "staticcall": 100,  # warm account (EIP-2929)
    "return": 0, "revert": 0, "stop": 0, "keccak256": 30,
}
GAS_PUSH = 3        # literal / variable operand load (PUSH, DUP)
GAS_SWAP = 3        # assignment scheduling (SWAP)
GAS_JUMP = 11       # user call: JUMP(8) + JUMPDEST(1) + return PUSH-ish
GAS_EXP_BYTE = 50   # EIP-160
GAS_TX = 21000
GAS_CALLDATA_ZERO = 4
GAS_CALLDATA_NONZERO = 16  # EIP-2028
GAS_PRECOMPILE = {6: 150, 7: 6000}  # EIP-1108 (Istanbul)
GAS_PAIRING_BASE = 45000
GAS_PAIRING_PER_PAIR = 34000


def _modexp_gas(base_len: int, exp_len: int, mod_len: int,
                exp_head: int) -> int:
    """EIP-2565 modexp pricing."""
    words = (max(base_len, mod_len) + 7) // 8
    mult_complexity = words * words
    if exp_len <= 32:
        iteration_count = max(exp_head.bit_length() - 1, 0)
    else:  # pragma: no cover — generator always uses 32-byte exponents
        iteration_count = 8 * (exp_len - 32) + max(
            exp_head.bit_length() - 1, 0)
    iteration_count = max(iteration_count, 1)
    return max(200, mult_complexity * iteration_count // 3)


def _mem_cost(words: int) -> int:
    """C_mem(a) = 3a + ⌊a²/512⌋ (yellow paper eq. 326)."""
    return 3 * words + words * words // 512


class VMRevert(Exception):
    pass


class _Return(Exception):
    def __init__(self, data: bytes):
        self.data = data


class _Leave(Exception):
    pass


class _Break(Exception):
    pass


class _Continue(Exception):
    pass


# --- lexer -----------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<comment>//[^\n]*|/\*.*?\*/)
  | (?P<hex>0x[0-9a-fA-F]+)
  | (?P<num>\d+)
  | (?P<str>"[^"]*")
  | (?P<ident>[A-Za-z_$][A-Za-z0-9_$.]*)
  | (?P<assign>:=)
  | (?P<arrow>->)
  | (?P<punct>[{}(),])
    """,
    re.VERBOSE | re.DOTALL,
)


def _tokenize(src: str) -> list:
    tokens = []
    pos = 0
    while pos < len(src):
        ch = src[pos]
        if ch.isspace():
            pos += 1
            continue
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise EigenError("parsing_error",
                             f"yul: bad token at {src[pos:pos+20]!r}")
        pos = m.end()
        if m.lastgroup == "comment":
            continue
        tokens.append((m.lastgroup, m.group()))
    return tokens


# --- parser ----------------------------------------------------------------

class _Parser:
    def __init__(self, tokens: list):
        self.tokens = tokens
        self.i = 0

    def peek(self, k: int = 0):
        if self.i + k < len(self.tokens):
            return self.tokens[self.i + k]
        return (None, None)

    def next(self):
        tok = self.peek()
        self.i += 1
        return tok

    def expect(self, value: str):
        kind, tok = self.next()
        if tok != value:
            raise EigenError("parsing_error",
                            f"yul: expected {value!r}, got {tok!r}")
        return tok

    # statements ----------------------------------------------------------
    def block(self) -> list:
        self.expect("{")
        stmts = []
        while self.peek()[1] != "}":
            stmts.append(self.statement())
        self.expect("}")
        return stmts

    def statement(self):
        kind, tok = self.peek()
        if tok == "{":
            return ("block", self.block())
        if tok == "function":
            return self.function_def()
        if tok == "let":
            self.next()
            names = self.name_list()
            value = None
            if self.peek()[1] == ":=":
                self.next()
                value = self.expression()
            return ("let", names, value)
        if tok == "if":
            self.next()
            cond = self.expression()
            return ("if", cond, self.block())
        if tok == "switch":
            self.next()
            subject = self.expression()
            cases, default = [], None
            while self.peek()[1] in ("case", "default"):
                _, which = self.next()
                if which == "case":
                    kind2, lit = self.next()
                    cases.append((int(lit, 0), self.block()))
                else:
                    default = self.block()
            return ("switch", subject, cases, default)
        if tok == "for":
            self.next()
            init = self.block()
            cond = self.expression()
            post = self.block()
            body = self.block()
            return ("for", init, cond, post, body)
        if tok in ("break", "continue", "leave"):
            self.next()
            return (tok,)
        # assignment or expression statement
        if kind == "ident" and self.peek(1)[1] in (":=", ","):
            names = self.name_list()
            self.expect(":=")
            return ("assign", names, self.expression())
        return ("expr", self.expression())

    def name_list(self) -> list:
        names = [self.next()[1]]
        while self.peek()[1] == ",":
            self.next()
            names.append(self.next()[1])
        return names

    def function_def(self):
        self.expect("function")
        _, name = self.next()
        self.expect("(")
        params = []
        while self.peek()[1] != ")":
            params.append(self.next()[1])
            if self.peek()[1] == ",":
                self.next()
        self.expect(")")
        rets = []
        if self.peek()[1] == "->":
            self.next()
            rets = self.name_list()
        return ("function", name, params, rets, self.block())

    # expressions ---------------------------------------------------------
    def expression(self):
        kind, tok = self.next()
        if kind in ("hex", "num"):
            return ("lit", int(tok, 0) & WORD)
        if kind != "ident":
            raise EigenError("parsing_error", f"yul: bad expression {tok!r}")
        if self.peek()[1] == "(":
            self.next()
            args = []
            while self.peek()[1] != ")":
                args.append(self.expression())
                if self.peek()[1] == ",":
                    self.next()
            self.expect(")")
            return ("call", tok, args)
        return ("var", tok)


def parse(src: str) -> list:
    """Parse Yul source → statement list. Accepts either a bare block or
    an ``object`` wrapper, in which case the ``object "runtime"`` code
    block (the deployed verifier) is extracted."""
    tokens = _tokenize(src)
    # object form: scan for object "runtime" { code { ... } }
    for i in range(len(tokens) - 3):
        if (tokens[i][1] == "object" and tokens[i + 1][1] == '"runtime"'):
            j = i + 2
            while tokens[j][1] != "code":
                j += 1
            p = _Parser(tokens)
            p.i = j + 1
            return p.block()
    p = _Parser(tokens)
    if tokens and tokens[0][1] == "{":
        return p.block()
    stmts = []
    while p.peek()[0] is not None:
        stmts.append(p.statement())
    return stmts


# --- precompiles -----------------------------------------------------------

def _precompile(addr: int, data: bytes):
    from .bn254 import BN254_FQ_MODULUS as Q
    from .bn254 import g1_add, g1_is_on_curve, g1_mul, pairing_check

    def word(i):
        chunk = data[i * 32:(i + 1) * 32]
        return int.from_bytes(chunk.ljust(32, b"\x00"), "big")

    def pt(i):
        x, y = word(i), word(i + 1)
        if x == 0 and y == 0:
            return None
        if x >= Q or y >= Q:
            raise VMRevert("coordinate out of field")
        p = (x, y)
        if not g1_is_on_curve(p):
            raise VMRevert("point not on curve")
        return p

    def enc(p):
        if p is None:
            return b"\x00" * 64
        return p[0].to_bytes(32, "big") + p[1].to_bytes(32, "big")

    if addr == 5:  # modexp, fixed 32/32/32 layout
        blen, elen, mlen = word(0), word(1), word(2)
        if (blen, elen, mlen) != (32, 32, 32):
            raise VMRevert("modexp: unsupported layout")
        b, e, m = word(3), word(4), word(5)
        return ((pow(b, e, m) if m else 0).to_bytes(32, "big"),
                _modexp_gas(32, 32, 32, e))
    if addr == 6:
        return enc(g1_add(pt(0), pt(2))), GAS_PRECOMPILE[6]
    if addr == 7:
        return enc(g1_mul(pt(0), word(2))), GAS_PRECOMPILE[7]
    if addr == 8:
        if len(data) % 192 != 0:
            raise VMRevert("pairing: bad input size")
        npairs = len(data) // 192
        pairs = []
        for p_i in range(npairs):
            base = p_i * 6
            g1 = pt(base)
            # EVM G2 layout: x_c1, x_c0, y_c1, y_c0
            x = (word(base + 3), word(base + 2))
            y = (word(base + 5), word(base + 4))
            g2 = None if all(v == 0 for v in (*x, *y)) else (x, y)
            if g1 is None or g2 is None:
                continue  # identity pairs contribute the unit
            pairs.append((g1, g2))
        ok = pairing_check(pairs) if pairs else True
        gas = GAS_PAIRING_BASE + GAS_PAIRING_PER_PAIR * npairs
        return (1 if ok else 0).to_bytes(32, "big"), gas
    raise VMRevert(f"unknown precompile {addr}")


# --- evaluator -------------------------------------------------------------

class YulVM:
    """One execution = one external call: (calldata) → returndata."""

    def __init__(self, src_or_ast):
        self.ast = parse(src_or_ast) if isinstance(src_or_ast, str) else src_or_ast

    def run(self, calldata: bytes) -> tuple:
        """(returndata, execution gas) — the message-call cost, replayed
        under the yellow-paper schedule. Raises VMRevert on revert."""
        self.calldata = calldata
        self.memory = bytearray()
        self.gas = 0
        self.mem_words = 0
        try:
            self._block(self.ast, [{}])
        except _Return as r:
            return r.data, self.gas
        return b"", self.gas

    def run_tx(self, calldata: bytes) -> tuple:
        """(returndata, transaction gas): execution + the 21000
        intrinsic cost + EIP-2028 calldata bytes — the number an
        on-chain caller actually pays for `verifier.verify(proof)`."""
        data, exec_gas = self.run(calldata)
        cd = sum(GAS_CALLDATA_ZERO if b == 0 else GAS_CALLDATA_NONZERO
                 for b in calldata)
        return data, exec_gas + GAS_TX + cd

    # memory --------------------------------------------------------------
    def _touch(self, offset: int, size: int) -> None:
        """Quadratic memory-expansion charge for [offset, offset+size)."""
        if size <= 0:
            return
        words = (offset + size + 31) // 32
        if words > self.mem_words:
            self.gas += _mem_cost(words) - _mem_cost(self.mem_words)
            self.mem_words = words

    def _mem(self, offset: int, size: int) -> bytes:
        self._touch(offset, size)
        end = offset + size
        if end > len(self.memory):
            self.memory.extend(b"\x00" * (end - len(self.memory)))
        return bytes(self.memory[offset:end])

    def _mem_write(self, offset: int, data: bytes) -> None:
        self._touch(offset, len(data))
        end = offset + len(data)
        if end > len(self.memory):
            self.memory.extend(b"\x00" * (end - len(self.memory)))
        self.memory[offset:end] = data

    # scopes --------------------------------------------------------------
    def _lookup(self, scopes, name):
        for scope in reversed(scopes):
            if name in scope:
                return scope
        raise EigenError("parsing_error", f"yul: undefined {name}")

    def _collect_functions(self, stmts, scopes):
        # functions hoist to the global scope: Yul lets any function call
        # any other regardless of block position, and user calls execute
        # with [global, frame] scopes only
        for st in stmts:
            if st[0] == "function":
                scopes[0][st[1]] = ("__fn__", st)

    def _block(self, stmts, scopes):
        scopes.append({})
        self._collect_functions(stmts, scopes)
        try:
            for st in stmts:
                self._stmt(st, scopes)
        finally:
            scopes.pop()

    def _stmt(self, st, scopes):
        op = st[0]
        if op == "function":
            return
        if op == "block":
            self._block(st[1], scopes)
        elif op == "let":
            values = self._values(st[2], scopes, len(st[1])) \
                if st[2] is not None else [0] * len(st[1])
            for name, v in zip(st[1], values):
                scopes[-1][name] = v
        elif op == "assign":
            values = self._values(st[2], scopes, len(st[1]))
            self.gas += GAS_SWAP * len(st[1])
            for name, v in zip(st[1], values):
                self._lookup(scopes, name)[name] = v
        elif op == "if":
            if self._eval(st[1], scopes):
                self._block(st[2], scopes)
        elif op == "switch":
            subject = self._eval(st[1], scopes)
            for value, body in st[2]:
                if subject == value:
                    self._block(body, scopes)
                    return
            if st[3] is not None:
                self._block(st[3], scopes)
        elif op == "for":
            scopes.append({})
            self._collect_functions(st[1], scopes)
            try:
                for init_st in st[1]:
                    self._stmt(init_st, scopes)
                while self._eval(st[2], scopes):
                    try:
                        self._block(st[4], scopes)
                    except _Continue:
                        pass
                    for post_st in st[3]:
                        self._stmt(post_st, scopes)
            except _Break:
                pass
            finally:
                scopes.pop()
        elif op == "break":
            raise _Break()
        elif op == "continue":
            raise _Continue()
        elif op == "leave":
            raise _Leave()
        elif op == "expr":
            self._eval(st[1], scopes)
        else:  # pragma: no cover
            raise EigenError("parsing_error", f"yul: bad statement {op}")

    def _values(self, expr, scopes, count):
        v = self._eval(expr, scopes, multi=count > 1)
        if count == 1:
            return [v]
        if not isinstance(v, tuple) or len(v) != count:
            raise EigenError("parsing_error", "yul: arity mismatch")
        return list(v)

    # expression evaluation ------------------------------------------------
    def _eval(self, expr, scopes, multi=False):
        kind = expr[0]
        if kind == "lit":
            self.gas += GAS_PUSH
            return expr[1]
        if kind == "var":
            self.gas += GAS_PUSH  # DUP/PUSH of the scheduled stack slot
            return self._lookup(scopes, expr[1])[expr[1]]
        name, args = expr[1], expr[2]
        # user function?
        for scope in reversed(scopes):
            if name in scope and isinstance(scope[name], tuple) \
                    and scope[name][0] == "__fn__":
                return self._call_user(scope[name][1], args, scopes)
        return self._builtin(name, [self._eval(a, scopes) for a in args])

    def _call_user(self, fn, arg_exprs, scopes):
        _, name, params, rets, body = fn
        args = [self._eval(a, scopes) for a in arg_exprs]
        if len(args) != len(params):
            raise EigenError("parsing_error", f"yul: arity in {name}")
        # Yul function scope: only globals (functions) + own locals
        frame = dict(zip(params, args))
        for r in rets:
            frame[r] = 0
        fn_scopes = [scopes[0], frame]
        self.gas += GAS_JUMP
        try:
            self._block(body, fn_scopes)
        except _Leave:
            pass
        if not rets:
            return 0
        if len(rets) == 1:
            return frame[rets[0]]
        return tuple(frame[r] for r in rets)

    def _builtin(self, name, a):
        self.gas += GAS.get(name, 3)
        if name == "add":
            return (a[0] + a[1]) & WORD
        if name == "sub":
            return (a[0] - a[1]) & WORD
        if name == "mul":
            return (a[0] * a[1]) & WORD
        if name == "div":
            return a[0] // a[1] if a[1] else 0
        if name == "mod":
            return a[0] % a[1] if a[1] else 0
        if name == "addmod":
            return (a[0] + a[1]) % a[2] if a[2] else 0
        if name == "mulmod":
            return (a[0] * a[1]) % a[2] if a[2] else 0
        if name == "exp":
            self.gas += GAS_EXP_BYTE * ((a[1].bit_length() + 7) // 8)
            return pow(a[0], a[1], 1 << 256)
        if name == "lt":
            return 1 if a[0] < a[1] else 0
        if name == "gt":
            return 1 if a[0] > a[1] else 0
        if name == "eq":
            return 1 if a[0] == a[1] else 0
        if name == "iszero":
            return 1 if a[0] == 0 else 0
        if name == "and":
            return a[0] & a[1]
        if name == "or":
            return a[0] | a[1]
        if name == "xor":
            return a[0] ^ a[1]
        if name == "not":
            return a[0] ^ WORD
        if name == "shl":
            return (a[1] << a[0]) & WORD if a[0] < 256 else 0
        if name == "shr":
            return a[1] >> a[0] if a[0] < 256 else 0
        if name == "mload":
            return int.from_bytes(self._mem(a[0], 32), "big")
        if name == "mstore":
            self._mem_write(a[0], a[1].to_bytes(32, "big"))
            return 0
        if name == "keccak256":
            data = self._mem(a[0], a[1])  # 30 base charged from GAS
            self.gas += 6 * ((len(data) + 31) // 32)
            from ..utils.keccak import keccak256 as _k

            return int.from_bytes(_k(bytes(data)), "big")
        if name == "calldataload":
            chunk = self.calldata[a[0]:a[0] + 32]
            return int.from_bytes(chunk.ljust(32, b"\x00"), "big")
        if name == "calldatasize":
            return len(self.calldata)
        if name == "gas":
            return 10**9  # interpreter does not meter a real gas limit
        if name == "staticcall":
            _, addr, in_off, in_size, out_off, out_size = a
            try:
                out, gas = _precompile(addr, self._mem(in_off, in_size))
            except VMRevert:
                return 0
            self.gas += gas
            self._mem_write(out_off, out[:out_size])
            return 1
        if name == "revert":
            raise VMRevert(self._mem(a[0], a[1]))
        if name == "return":
            raise _Return(self._mem(a[0], a[1]))
        if name == "stop":
            raise _Return(b"")
        if name == "pop":
            return 0
        raise EigenError("parsing_error", f"yul: unknown builtin {name}")
