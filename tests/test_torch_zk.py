"""The port's proving stack against the JAX package's: the SRS, the keys,
the EigenTrust circuit and the proof verbs.

Every comparison is exact: the SRS and the keys are byte strings, the
circuit a list of rows. The port's modules are copies of the
reference's host code on the port's own prover core
(``csrc/prover_native.cpp``); these tests hold the copies to the
originals. Small sizes only (k = 6 artifacts, the 2-peer tiny circuit);
the k = 20 cycle runs on the card in ``chip_smoke.py``'s phase prove.
"""

import random

import pytest
import torch

from protocol_tpu.cli.main import main as ref_main
from protocol_tpu.zk import api as ref_api
from protocol_tpu.zk import prover_fast as ref_pf
from protocol_tpu.zk.kzg import KZGParams as RefParams
from protocol_tpu_torch.cli.main import main as port_main
from protocol_tpu_torch.native import prover as port_native
from protocol_tpu_torch.utils.fields import BN254_FR_MODULUS as R
from protocol_tpu_torch.zk import api as port_api
from protocol_tpu_torch.zk import prover_fast as port_pf
from protocol_tpu_torch.zk.kzg import KZGParams as PortParams
from protocol_tpu_torch.zk.plonk import ConstraintSystem

if not port_native.available():
    pytest.skip("the port's prover core did not build",
                allow_module_level=True)

SEED = b"torch-zk"


def synthetic_cs(rows: int = 20, seed: int = 11) -> ConstraintSystem:
    """A multiply-add circuit with one copy-constrained lookup row and a
    public input (the reference's lockstep fixture)."""
    rng = random.Random(seed)
    cs = ConstraintSystem(lookup_bits=6)
    for _ in range(rows):
        a, b = rng.randrange(50), rng.randrange(50)
        cs.add_row([a, b, (a * b + a) % R], q_a=1, q_mul_ab=1, q_c=R - 1)
    lk = cs.lookup_row(37)
    row = cs.add_row([37], q_a=1, q_const=R - 37)
    cs.copy(lk, (0, row))
    cs.public_input(777)
    cs.check_satisfied()
    return cs


@pytest.fixture(scope="module")
def srs():
    return (port_pf.setup_params_fast(6, seed=SEED),
            ref_pf.setup_params_fast(6, seed=SEED))


def test_srs_bytes_equal_reference(srs):
    port, ref = srs
    blob = port.to_bytes()
    assert blob == ref.to_bytes()
    assert port.g1_lagrange is not None and len(port.g1_lagrange) == 64
    # each package parses the other's file back to the same bytes
    assert RefParams.from_bytes(blob).to_bytes() == blob
    assert PortParams.from_bytes(blob).to_bytes() == blob


@pytest.mark.parametrize("eval_pk", [True, False])
def test_keygen_bytes_equal_reference(srs, eval_pk):
    port, ref = srs
    port_key = port_pf.keygen_fast(port, synthetic_cs(), eval_pk=eval_pk)
    ref_key = ref_pf.keygen_fast(ref, synthetic_cs(), eval_pk=eval_pk)
    assert port_key.eval_form is eval_pk
    assert port_key.to_bytes() == ref_key.to_bytes()


def test_et_circuit_tiny_shape_equals_reference():
    """The 2-peer / 2-iteration EigenTrust circuit (the tiny shape the
    CLI proves at k = 20), built by each package from its own demo
    setup: the same rows, public values and constraint system (every
    column, selector, copy constraint and public row)."""
    shape = port_api.TINY_SHAPE
    assert vars(shape) == vars(ref_api.TINY_SHAPE)
    chips, pubs = port_api._et_setup_circuit(port_api.demo_et_setup(shape),
                                             shape)
    ref_chips, ref_pubs = ref_api._et_setup_circuit(
        ref_api.demo_et_setup(ref_api.TINY_SHAPE), ref_api.TINY_SHAPE)
    assert pubs == ref_pubs
    assert chips.cs.num_rows == ref_chips.cs.num_rows
    assert chips.cs.public_values() == ref_chips.cs.public_values()
    assert port_pf.natural_k(chips.cs) == 20
    for field in ("wires", "selectors", "copies", "public_rows",
                  "lookup_bits"):
        assert getattr(chips.cs, field) == getattr(ref_chips.cs, field), \
            field


def test_kzg_params_verb_round_trips(tmp_path, capsys):
    """``kzg-params`` in each package writes an SRS the other reads back
    to the same bytes (tau is fresh per run, so the files differ)."""
    files = {}
    for main, name in ((port_main, "port"), (ref_main, "ref")):
        assets = tmp_path / name
        assert main(["--assets", str(assets), "kzg-params", "--k", "3"]) == 0
        assert "kzg-params-3.bin" in capsys.readouterr().out
        files[name] = (assets / "kzg-params-3.bin").read_bytes()
    for blob in files.values():
        assert PortParams.from_bytes(blob).to_bytes() == blob
        assert RefParams.from_bytes(blob).to_bytes() == blob
        params = PortParams.from_bytes(blob)
        assert params.k == 3 and len(params.g1_lagrange) == 8


def test_proof_verbs_need_the_card_or_device_cpu(tmp_path, capsys):
    """``et-proof`` runs rounds 3–4 on the card: with none and no
    ``--device cpu`` it exits 1 naming the flag, before it reads an
    artifact. The host verbs take no card: ``et-verify`` without
    artifacts fails on the missing file, not on the device."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    assets = ["--assets", str(tmp_path)]
    assert port_main([*assets, "et-proof", "--shape", "tiny"]) == 1
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "--device cpu" in err
    assert port_main([*assets, "et-verify", "--shape", "tiny"]) == 1
    err = capsys.readouterr().err
    assert "missing artifact" in err and "CUDA" not in err
    # with --device cpu it gets past the device and stops on the data
    assert port_main([*assets, "et-proof", "--shape", "tiny",
                      "--device", "cpu"]) == 1
    assert "CUDA" not in capsys.readouterr().err
    assert list(tmp_path.glob("et-proof*")) == []


@pytest.mark.parametrize("fn", ["generate_th_pk", "generate_th_proof"])
def test_threshold_proves_need_the_card_or_a_cpu_device(fn):
    """Both Threshold api calls prove: given no device on a box without a
    card they raise before they parse an artifact (the bytes here are
    empty), as ``generate_et_proof`` does."""
    from types import SimpleNamespace

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    setup = SimpleNamespace(et_setup=object(), ratio=1)
    args = {"generate_th_pk": (b"",),
            "generate_th_proof": (b"", b"", setup)}[fn]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(port_api, fn)(*args)


def test_proof_bytes_verify_under_either_package(srs):
    """A proof by either package verifies under the other's ``verify``
    (and a key written by one loads in the other)."""
    from protocol_tpu.zk.plonk import verify as ref_verify
    from protocol_tpu_torch.zk.plonk import verify as port_verify

    port, ref = srs
    cs = synthetic_cs(rows=12, seed=5)
    port_key = port_pf.keygen_fast(port, cs, eval_pk=True)
    ref_key = ref_pf.FastProvingKey.from_bytes(port_key.to_bytes())
    r1, r2 = random.Random(3), random.Random(3)
    p_port = port_pf.prove_fast(port, port_key, cs,
                                randint=lambda: r1.randrange(R))
    p_ref = ref_pf.prove_fast(ref, ref_key, synthetic_cs(rows=12, seed=5),
                              randint=lambda: r2.randrange(R))
    assert p_port == p_ref
    pubs = cs.public_values()
    assert ref_verify(ref, ref_key, pubs, p_port)
    assert port_verify(port, port_key, pubs, p_ref)
