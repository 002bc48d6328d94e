"""The slice parity test of the service: one chain tailed by the
reference's daemon and the port's side by side (the daemon helpers are
``test_torch_service``'s)."""

import numpy as np
import torch

from protocol_tpu_torch.client.eth import (
    address_from_public_key,
    ecdsa_keypairs_from_mnemonic,
)
from test_torch_service import (  # noqa: F401 - devnet is a fixture
    MNEMONIC,
    _attest_round,
    _make_service,
    devnet,
)


def test_slice_parity_with_reference_daemon(tmp_path, devnet):
    """One chain, two daemons: the reference's ``TrustService``
    (``JaxRoutedBackend``, float64) and the port's
    (``TorchRoutedBackend``, float64), both with
    ``routed_edge_threshold=1`` so the routed build and then the delta
    engine and its ladder serve every refresh. Driven by hand (one poll
    and one refresh a round, no threads), so both see the same windows:
    every round publishes the same revision with the same iteration
    count and scores within the reference's service-test tolerance."""
    import jax.numpy as jnp
    from protocol_tpu.backend import JaxRoutedBackend
    from protocol_tpu.client import Client as RefClient
    from protocol_tpu.client import ClientConfig as RefClientConfig
    from protocol_tpu.service import FaultInjector as RefFaults
    from protocol_tpu.service import ServiceConfig as RefServiceConfig
    from protocol_tpu.service import TrustService as RefTrustService

    from protocol_tpu_torch.backend import TorchRoutedBackend

    _, node_url = devnet
    knobs = dict(port=0, tol=1e-10, routed_edge_threshold=1)
    port, client = _make_service(
        tmp_path / "port", node_url,
        backend=TorchRoutedBackend(dtype=torch.float64, device="cpu"),
        **knobs)
    ref_cfg = RefClientConfig(
        as_address="0x" + client.chain.contract_address.hex(),
        node_url=node_url, domain="0x" + "00" * 20)
    ref = RefTrustService(
        RefClient(ref_cfg, MNEMONIC), RefServiceConfig(**knobs),
        str(tmp_path / "ref-cursor"),
        provers={"echo": lambda params: params},
        backend=JaxRoutedBackend(dtype=jnp.float64),
        faults=RefFaults({"rpc": 0.0, "device": 0.0, "disk": 0.0}))
    kps = ecdsa_keypairs_from_mnemonic(MNEMONIC, 5)
    addrs = [address_from_public_key(kp.public_key) for kp in kps]

    def round_trip():
        for svc in (ref, port):
            svc.tailer.poll_once()
            svc.refresher.refresh()
        a, b = ref.refresher.table, port.refresher.table
        assert a.revision == b.revision == port.graph.revision
        assert a.iterations == b.iterations
        assert a.addresses == b.addresses
        np.testing.assert_allclose(b.scores, a.scores, rtol=1e-3)
        return b

    # cold: four peers attest each other (the routed build)
    _attest_round(client, kps[:4], addrs[:4],
                  {(i, j): 2 + (i + 3 * j) % 7
                   for i in range(4) for j in range(4) if i != j})
    t = round_trip()
    assert t.cold and port.refresher.operator_builds == 1
    # churn: weight revisions, a new peer and edges to it (structural
    # inserts) — absorbed by the delta engines, no second build on
    # either side
    for i, j, v in ((0, 1, 9), (2, 3, 1), (4, 0, 6), (1, 4, 4)):
        client.keypairs[0] = kps[i]
        client.attest(addrs[j], v)
    t = round_trip()
    assert len(t.addresses) == 5 and not t.cold
    assert port.refresher.operator_builds == ref.refresher.operator_builds
    assert port.refresher.delta_batches == ref.refresher.delta_batches >= 1
    # the tail's capacity differs by design: the reference pads it to a
    # power of two, the port holds one entry per edge
    ds_port, ds_ref = (dict(r.refresher.delta_status(), tail_capacity=None)
                       for r in (port, ref))
    assert ds_port == ds_ref and ds_port["anchored"]
