"""The coordinator store of a world of ranks (parallel/multihost.host_store):
the caller binds it on a port the OS picks, and holds that port until the
world ends, so that concurrent test workers cannot take it between its
choice and its use (free_port's hazard: any outgoing connection may be
given the port it returned).  A rank that must host the store on a held
port fails with EADDRINUSE; ranks that join the hosted store complete."""

import os
import socket
import subprocess
import sys

import pytest
import torch.distributed as dist

from rowbowt_tpu_torch.parallel import multihost as mh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sum_ranks(device):
    """A world's work: the sum of the ranks over gloo, and this rank's id."""
    import torch

    t = torch.tensor([dist.get_rank()])
    dist.all_reduce(t)
    return int(t.item()), dist.get_rank(), dist.get_world_size()


def test_host_store_holds_its_port():
    """While the store is held, its port is bound: binding it fails, and no
    free_port caller is handed it."""
    store = mh.host_store()
    port = store.port
    assert 0 < port < 65536
    with socket.socket() as s:
        with pytest.raises(OSError) as err:
            s.bind(("localhost", port))
    assert err.value.errno == 98  # EADDRINUSE
    assert port not in {mh.free_port() for _ in range(200)}
    store.set("probe", "1")
    assert store.get("probe") == b"1"


def test_rank0_cannot_host_on_a_held_port_but_joins_the_hosted_store():
    """Rank 0 of a world that hosts its own store on a port another process
    holds fails with EADDRINUSE (the race of a port chosen by free_port and
    taken before rank 0 binds it); the same rank joining the held store as
    a client (hosted=True) completes."""
    store = mh.host_store()
    coordinator = f"localhost:{store.port}"
    code = ("import sys; from rowbowt_tpu_torch.parallel import multihost as mh\n"
            "mh.init(sys.argv[1], 1, 0, backend='gloo', device='cpu', timeout_s=20,\n"
            "        hosted=sys.argv[2] == '1')\n"
            "import torch, torch.distributed as dist\n"
            "t = torch.ones(1); dist.all_reduce(t); print(int(t.item())); mh.shutdown()\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for hosted in ("0", "1"):
        r = subprocess.run([sys.executable, "-c", code, coordinator, hosted], cwd=REPO,
                           env=env, capture_output=True, text=True, timeout=120)
        if hosted == "0":
            assert r.returncode != 0 and "EADDRINUSE" in r.stderr + r.stdout, r.stderr[-2000:]
        else:
            assert r.returncode == 0 and r.stdout.strip() == "1", r.stderr[-2000:]


def test_run_local_world_joins_its_hosted_store():
    """run_local hosts the store in this process and every rank joins it:
    a world of two gloo ranks on the CPU completes with each rank's share."""
    out = mh.run_local(_sum_ranks, 2, backend="gloo", device="cpu", timeout_s=120)
    assert out == [(1, 0, 2), (1, 1, 2)]
