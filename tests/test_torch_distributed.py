"""Multi-process training in the port: the world, the global mesh, checkpoints and commits.

One world of four ``gloo`` ranks (``tests/helpers/torch_mesh.py``, suite
``checkpoint``) trains the float32 case of ``tests/test_parallel.py``'s
sizes and hands back, as JSON:

* the global (slice 2, batch 1, paths 2) mesh against the flat (2, 2) mesh:
  the same coordinates, losses and replica bytes (tier 1, exact);
* ``make_sharded_segment`` against the trainer's segment (exact);
* a run under ``FinalAndIntervalCommit(2)`` with ``coordinator_only``
  commits into one filesystem chain: rank 0 commits at steps 2 and 4, the
  other ranks never; its snapshot resumes single-device in the port and in
  the JAX package (their continuations agree to rtol 2e-4, tier 2);
* a same-mesh resume after 2 of the 4 steps: bit-equal to the uninterrupted
  run;
* a mid-stream ``"cuda"`` American checkpoint (LSMC backward 3) refused on a
  mesh with ``EngineMismatch``, as the JAX package refuses its fused
  backward's;
* ``initialize_distributed`` called again on every rank: the same arguments
  return the world, others fail loudly.

In this process: a query before any join does not latch, and ``nccl``
without a card fails instead of becoming ``gloo``.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest
import torch
import torch.distributed as dist

from spectralmc_tpu.serialization.converters import (
    deserialize_checkpoint as jax_deserialize_checkpoint,
)
from spectralmc_tpu.training import trainer as jtr
from spectralmc_tpu_torch.parallel import distributed as pdist
from spectralmc_tpu_torch.serialization import deserialize_checkpoint
from spectralmc_tpu_torch.storage import (
    AsyncBlockchainModelStore,
    ChainValid,
    FileSystemObjectStore,
    verify_chain_detailed,
)
from spectralmc_tpu_torch.training.trainer import GbmCVNNPricer, build_training_config
from tests.helpers import torch_mesh as tm


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("checkpoint")
    run = tm.start_ranks("checkpoint", tmp)
    yield run, tmp
    run.stop()


def test_query_before_join_does_not_latch() -> None:
    res = pdist.initialize_distributed()
    assert res.is_success()
    assert res.value == pdist.DistributedRuntime(0, 1, 0, 0)
    assert not dist.is_initialized() and pdist._init_args is None
    assert pdist.is_coordinator()
    assert pdist.current_runtime().is_coordinator


def test_nccl_without_a_card_fails_and_never_becomes_gloo(tmp_path, monkeypatch) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    res = pdist.initialize_distributed(coordinator_address=f"file://{tmp_path / 'rdv'}",
                                       num_processes=1, process_id=0, device_type="cuda")
    assert res.is_failure() and "nccl" in res.error.reason
    assert not dist.is_initialized() and pdist._init_args is None
    bad = pdist.initialize_distributed(coordinator_address="localhost:1", num_processes=2,
                                       process_id=0, device_type="tpu")
    assert bad.is_failure() and bad.error.field == "distributed"


def test_explicit_join_must_name_its_device_type(tmp_path) -> None:
    res = pdist.initialize_distributed(coordinator_address=f"file://{tmp_path / 'rdv'}",
                                       num_processes=1, process_id=0)
    assert res.is_failure() and "device_type" in res.error.reason
    assert not dist.is_initialized() and pdist._init_args is None
    assert pdist.joined_device_type() is None


def test_coordinator_only_gates_at_call_time(monkeypatch) -> None:
    calls = []
    gated = pdist.coordinator_only(calls.append, name="record")
    assert gated.__name__ == "coordinator_only_record"
    assert gated(1) is None and calls == [1]  # no world: this process is rank 0
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda *a, **k: 3)
    assert gated(2) is None and calls == [1]


def test_global_mesh_is_bit_equal_to_the_flat_mesh(world) -> None:
    runs = world[0].wait()
    for r in runs:
        assert r["coords"]["global"] == r["coords"]["flat"]
        assert r["global"] == r["flat"]
    assert len({r["flat"]["state"] for r in runs}) == 1
    assert [r["coords"]["flat"] for r in runs] == [[0, 0], [0, 1], [1, 0], [1, 1]]


def test_sharded_segment_equals_the_trainers(world) -> None:
    for r in world[0].wait():
        assert r["segment"] == r["flat"]["losses"]


def test_same_mesh_resume_is_bit_exact(world) -> None:
    for r in world[0].wait():
        assert r["resumed"]["losses"] == r["whole"]["losses"]
        assert r["resumed"]["state"] == r["whole"]["state"]


def test_only_rank_zero_commits_into_one_chain(world) -> None:
    runs, tmp = world
    runs = runs.wait()
    assert [m.split()[0] for m in runs[0]["commits"]] == ["step=2", "step=4"]
    assert all(r["commits"] == [] for r in runs[1:])
    store = AsyncBlockchainModelStore(FileSystemObjectStore(str(tmp / "store"), "models"))
    assert asyncio.run(verify_chain_detailed(store)).expect("verify") == ChainValid(versions=2)
    assert runs[0]["whole"]["losses"] == runs[0]["flat"]["losses"]


def test_sharded_snapshot_resumes_single_device_in_both_packages(world) -> None:
    runs, tmp = world
    runs.wait()
    data = (tmp / "sharded.ckpt").read_bytes()
    port = GbmCVNNPricer.create(deserialize_checkpoint(data).expect("port decode"),
                                device="cpu").expect("port resume")
    cfg = build_training_config(num_batches=2, batch_size=8, learning_rate=2e-3).expect("cfg")
    port_losses = np.asarray(port.train(cfg).expect("port train").losses)
    jax = jtr.GbmCVNNPricer.create(jax_deserialize_checkpoint(data).expect("jax decode")).expect(
        "jax resume")
    jcfg = jtr.build_training_config(num_batches=2, batch_size=8, learning_rate=2e-3).expect("c")
    jax_losses = np.asarray(jax.train(jcfg).expect("jax train").losses)
    assert port.global_step == 6 and jax.global_step == 6
    assert np.all(np.isfinite(port_losses))
    np.testing.assert_allclose(port_losses, jax_losses, rtol=2e-4)


def test_mid_stream_cuda_american_is_refused_on_a_mesh(world) -> None:
    for r in world[0].wait():
        assert r["mid_stream_backward"] == 3
        assert r["refused_on_mesh"]


def test_chunk_and_batch_checks_see_the_shard(world) -> None:
    for r in world[0].wait():
        assert "per-shard batch 12" in r["chunk_refused"]
        assert "not divisible by batch axis 2" in r["indivisible_batch"]


def test_a_cpu_world_refuses_a_card_pricer(world) -> None:
    """A world joined for the CPU (gloo) cannot quietly reduce CUDA tensors."""
    for r in world[0].wait():
        assert r["joined_for"] == "cpu"
        assert "joined for cpu" in r["card_pricer_refused"]


def test_initialize_again_is_idempotent_and_refuses_another_topology(world) -> None:
    for rank, r in enumerate(world[0].wait()):
        again = r["init_again"]
        assert again["same_ok"] and again["same_rank"] == rank
        assert again["other_refused"] and "different arguments" in again["other_reason"]
