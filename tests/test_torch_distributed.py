"""The port's split over real ranks, on the CPU: the collective census at 2
and 4 ranks (in this process, over torch's in-process 'fake' backend, which
carries no data), the multi-process worker over gloo
(tpu_viterbi_torch/scripts/distributed_worker.py: decode_sharded and the
simulation agree with the in-process ranks on every rank), the CLI's
--e2e-device under two ranks, and the mesh's rules: its backend, its no-op
at one process and no fallback to the CPU."""

import os
import socket
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from tpu_viterbi_torch import cli
from tpu_viterbi_torch.config import ChannelIn, DecodeOut, DecoderConfig
from tpu_viterbi_torch.sharding import audit, mesh as mesh_mod
from tpu_viterbi_torch.sharding.blocks import halo_words

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 240            # each subprocess wait's own limit


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def fake_group():
    """Join an in-process 'fake' group as rank r of n (no data moves); the
    group is destroyed after the test."""
    def join(rank: int, n: int):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", rank=rank, world_size=n,
                                store=FakeStore())
        return mesh_mod.make_block_mesh("cpu")
    yield join
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("cfg", [
    DecoderConfig(ChannelIn.SOFT8),
    DecoderConfig(ChannelIn.HARD, decode_out=DecodeOut.O_B16),
    DecoderConfig(ChannelIn.FP32)], ids=["SOFT8", "HARD-b16", "FP32"])
def test_census_is_the_halo_and_one_scalar(fake_group, cfg):
    """At 2 and 4 ranks, every rank's census: one decode issues one halo
    exchange of halo_words (the wire's dtype); one simulate call that,
    one one-word exchange of the reference realignment and one int64
    all-reduce.  Nothing else, and the same at both rank counts."""
    seen = {}
    for n in (2, 4):
        for rank in (0, n - 1):
            mesh = fake_group(rank, n)
            assert (mesh.size, mesh.rank, mesh.backend) == (n, rank, "fake")
            dec = audit.audit_decoder(cfg, 2048, mesh, dec_len=256)
            simc = audit.audit_simulation(cfg, 3000 * n, mesh, dec_len=256)
            assert dec == audit.expected_census(cfg, False)
            assert simc == audit.expected_census(cfg, True)
            seen.setdefault("decode", set()).add(tuple(dec))
            seen.setdefault("simulate", set()).add(tuple(simc))
    wire = "float32" if cfg.channel_in == ChannelIn.FP32 else "int32"
    assert seen == {
        "decode": {(("permute", wire, halo_words(cfg)),)},
        "simulate": {(("permute", wire, halo_words(cfg)),
                      ("permute", "int32", 1), ("all_reduce", "int64", 1))}}


def _run_ranks(cmd, n: int, env_for=None):
    """Start n processes of ``cmd(rank, port)`` (subprocess: a fresh
    interpreter each, never a fork) and wait for each with its own limit;
    -> their (rc, stdout, stderr)."""
    port = _free_port()
    procs = [subprocess.Popen(cmd(r, port), cwd=REPO, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env={**os.environ, **(env_for(r, port)
                                                    if env_for else {})})
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WAIT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=WAIT_S)
    return outs


def _worker(n: int, *extra):
    outs = _run_ranks(lambda r, port: [
        sys.executable, "-m", "tpu_viterbi_torch.scripts.distributed_worker",
        "--coordinator", f"localhost:{port}", "--num-processes", str(n),
        "--process-id", str(r), "--device", "cpu", *extra], n)
    marks = []
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {rank}:\n{out[-3000:]}\n{err[-3000:]}"
        lines = sorted(ln for ln in out.splitlines()
                       if ln.startswith("DIST_OK"))
        assert [ln.split()[1] for ln in lines] == [
            "decode", "generator", "simulate"], out
        marks.append(lines)
    assert all(m == marks[0] for m in marks)     # every rank the same
    return marks[0]


def test_two_process_gloo_worker():
    """Two gloo ranks: decode_sharded, the simulation (noisy and
    noiseless) and the generated slabs agree with the in-process ranks
    and the one-rank stream on both ranks."""
    marks = _worker(2)
    assert "census=[('permute', 'int32', 32), ('permute', 'int32', 1), " \
        "('all_reduce', 'int64', 1)]" in marks[2]


@pytest.mark.slow   # a second multi-process spawn; the two-rank run stays
                    # the fast representative of the wiring
def test_four_process_gloo_worker_b16():
    """Four ranks (the > 2-rank cyclic halo) with b16 packs on HARD."""
    _worker(4, "-i", "h", "-o", "b16")


E2E = ["-n", "20000", "-s", "15", "-i", "s8", "--seed", "3",
       "--e2e-device", "-v", "--device", "cpu"]


def test_cli_e2e_under_two_ranks(capsys):
    """--e2e-device launched as two gloo ranks (torchrun's variables):
    rank 0 prints the one-process lines, its -v line names the ranks and
    the backend; rank 1 prints nothing on standard output."""
    outs = _run_ranks(
        lambda r, port: [sys.executable, "-m", "tpu_viterbi_torch", *E2E], 2,
        lambda r, port: {"MASTER_ADDR": "localhost",
                         "MASTER_PORT": str(port), "WORLD_SIZE": "2",
                         "RANK": str(r), "LOCAL_WORLD_SIZE": "2"})
    assert [rc for rc, _, _ in outs] == [0, 0], outs
    assert outs[1][1] == ""
    got = outs[0][1].splitlines()
    assert cli.main(E2E) == 0
    want = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 14
    assert got[8] == ("In-graph chain over 2 rank(s) (torch.distributed "
                      "backend gloo): 19936 bits decoded")
    assert want[8] == "In-graph chain over 1 device(s): 19936 bits decoded"
    assert got[:8] == want[:8] and got[11:] == want[11:] == [
        "", "Pipeline executed.", "Final results -> BEN: 0   BER: 0"]
    assert got[10].endswith("[BEN 0]")


def test_mesh_rules(monkeypatch):
    """No process group and no variables: initialize_distributed is a
    no-op and the mesh is one rank; the backend rule; 'cuda' without a
    card raises, never falls back."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    assert mesh_mod.initialize_distributed(device="cpu") is None
    m = mesh_mod.make_block_mesh("cpu")
    assert (m.rank, m.size, m.group) == (0, 1, None)
    t = torch.arange(5)
    assert m.shift_left(t) is t and m.all_reduce_sum(t) is t
    assert mesh_mod.backend_for(torch.device("cpu"), 2) == "gloo"
    with pytest.raises(ValueError, match="process"):
        mesh_mod.initialize_distributed("localhost:1", 2, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        mesh_mod.BlockMesh(0, 2, torch.device("cpu")).shift_left(t)
    if not torch.cuda.is_available():
        for fn in (mesh_mod.make_block_mesh,
                   mesh_mod.initialize_distributed):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn(device="cuda")


def test_collectives_hand_each_backend_its_device(fake_group, monkeypatch):
    """Under nccl every tensor handed to torch.distributed lies on the
    rank's card, a host tensor too (the CLI's seed), since a group with
    nccl alone refuses CPU tensors; under gloo every one lies on the host.
    What each collective returns lies on the rank's device.  The 'meta'
    device stands in for the card, which the tests may not have."""
    fake_group(0, 2)
    seen = []

    def record(*tensors):
        seen.extend(t.device.type for t in tensors)

    monkeypatch.setattr(dist, "broadcast",
                        lambda x, src, group=None: record(x))
    monkeypatch.setattr(dist, "all_reduce",
                        lambda x, op=None, group=None: record(x))
    monkeypatch.setattr(dist, "all_gather",
                        lambda parts, x, group=None: record(x, *parts))
    monkeypatch.setattr(dist, "batch_isend_irecv",
                        lambda ops: record(*(o.tensor for o in ops)) or [])
    card = torch.device("meta")
    seed, host = torch.tensor(12345), torch.arange(4, dtype=torch.int32)
    for backend, wire, inputs in (
            ("nccl", "meta", [host, torch.zeros(4, device=card)]),
            ("gloo", "cpu", [host])):
        mesh = mesh_mod.BlockMesh(0, 2, card, dist.group.WORLD, backend)
        seen.clear()
        assert mesh.broadcast(seed).device == card
        for t in inputs:
            outs = [mesh.broadcast(t), mesh.all_reduce_sum(t),
                    mesh.all_gather(t), mesh.shift_left(t)]
            assert {o.device.type for o in outs} == {"meta"}
        assert seen and set(seen) == {wire}, (backend, seen)
        assert [op for op, _, _ in mesh.census] == ["broadcast"] + [
            "broadcast", "all_reduce", "all_gather", "permute"] * len(inputs)
