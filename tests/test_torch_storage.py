"""The port's model chain, object stores, inference client and CLI (tier 1: exact).

One object-store contract runs over the port's in-memory, filesystem and S3
backends (S3 through ``tests/helpers/fake_aioboto3.py``, which mounts a
faithful aioboto3/botocore fake; the port's ``storage/s3_store.py`` imports
them on use). ``chain.json``, ``metadata.json``, ``content_hash.txt`` and the
record hashes are byte for byte the JAX package's for the same fields, so a
chain either package writes verifies, extends and serves in the other. The
behaviour is the JAX package's: compare-and-swap commits (a stale head is
``NotFastForward``, the loser's artifacts rolled back), corruption found,
garbage collected with tombstones, pinned and tracking serving with a hot
swap, ``FinalCommit`` through ``make_commit_fn``, and the CLI's exit codes.
"""

from __future__ import annotations

import asyncio
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spectralmc_tpu.storage import chain as jchain
from spectralmc_tpu.storage import store as jstore
from spectralmc_tpu.storage import verification as jverify
from spectralmc_tpu.storage.object_store import FileSystemObjectStore as JaxFileSystemStore
from spectralmc_tpu_torch.core.errors.storage import (
    BucketNotFound,
    ChecksumError,
    NetworkError,
    NotFastForward,
    ObjectNotFound,
    PreconditionFailed,
    Throttled,
    UnknownStoreError,
    VersionNotFound,
)
from spectralmc_tpu_torch.core.provenance import JaxEnv
from spectralmc_tpu_torch.core.result import Failure, Success
from spectralmc_tpu_torch.models import factory as tf
from spectralmc_tpu_torch.ops import gbm as tgbm
from spectralmc_tpu_torch.ops import sobol as tsobol
from spectralmc_tpu_torch.serialization import compute_sha256
from spectralmc_tpu_torch.storage import (
    AsyncBlockchainModelStore,
    ChainCorrupted,
    ChainValid,
    ExecuteGC,
    FileSystemObjectStore,
    InferenceClient,
    InMemoryObjectStore,
    PinnedMode,
    PreviewGC,
    RetentionPolicy,
    TrackingMode,
    commit_snapshot,
    create_genesis_version,
    create_next_version,
    find_corruption,
    load_snapshot_from_checkpoint,
    make_commit_fn,
    run_gc,
    verify_chain_detailed,
    verify_chain_links,
    verify_version_completeness,
)
from spectralmc_tpu_torch.storage import __main__ as cli
from spectralmc_tpu_torch.storage import chain as tchain
from spectralmc_tpu_torch.storage import store as tstore
from spectralmc_tpu_torch.storage.chain import ModelVersion, bump_semantic_version
from spectralmc_tpu_torch.storage.retry import (
    RetryExhausted,
    RetryGiveUp,
    RetryScheduled,
    decide_retry,
    retry_on_throttle,
    retry_schedule,
)
from spectralmc_tpu_torch.training import trainer as ttr
from tests.helpers import fake_aioboto3

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "checkpoints"
BACKENDS = ("memory", "filesystem", "s3")
FIXED_TIMESTAMP = "2026-01-02T03:04:05.678901+00:00"
BOUNDS = {
    "spot": (95.0, 105.0),
    "strike": (95.0, 105.0),
    "maturity": (0.5, 1.5),
    "rate": (0.01, 0.05),
    "div_yield": (0.0, 0.02),
    "vol": (0.2, 0.3),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one torch thread (the trainer steps are many small ops)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def run(coro):
    return asyncio.run(coro)


def _ok(result):
    assert isinstance(result, Success), f"expected Success, got {result!r}"
    return result.value


def _err(result):
    assert isinstance(result, Failure), f"expected Failure, got {result!r}"
    return result.error


def _commit(store, payload: bytes, message: str = "m"):
    return run(store.commit(payload, compute_sha256(payload), message))


def _s3_store(monkeypatch, bucket: str):
    fake_aioboto3.reset()
    fake_aioboto3.create_bucket(bucket)
    fake_aioboto3.install(monkeypatch)  # mounts the fake aioboto3/botocore modules
    from spectralmc_tpu_torch.storage.s3_store import S3ObjectStore

    return S3ObjectStore(bucket)


@pytest.fixture(params=BACKENDS)
def object_store(request, tmp_path, monkeypatch):
    if request.param == "memory":
        return InMemoryObjectStore("conformance")
    if request.param == "filesystem":
        return FileSystemObjectStore(str(tmp_path), "conformance")
    return _s3_store(monkeypatch, "conformance")


@pytest.fixture
def s3_only(monkeypatch):
    return _s3_store(monkeypatch, "faulty"), fake_aioboto3


@pytest.fixture
def store(tmp_path) -> AsyncBlockchainModelStore:
    return AsyncBlockchainModelStore(FileSystemObjectStore(tmp_path, "test-bucket"))


# --------------------------------------------------------------------------
# The object-store contract, over every backend
# --------------------------------------------------------------------------


def test_put_get_roundtrip_with_stable_etag(object_store) -> None:
    etag = _ok(run(object_store.put("a/b.txt", b"payload")))
    data, got_etag = _ok(run(object_store.get("a/b.txt")))
    assert (data, got_etag) == (b"payload", etag)
    assert _ok(run(object_store.put("a/b.txt", b"payload"))) == etag


def test_get_and_head_missing_key(object_store) -> None:
    assert isinstance(_err(run(object_store.get("nope"))), ObjectNotFound)
    assert isinstance(_err(run(object_store.head("nope"))), ObjectNotFound)


def test_head_reports_size_and_etag(object_store) -> None:
    etag = _ok(run(object_store.put("k", b"12345")))
    assert _ok(run(object_store.head("k"))) == (5, etag)


def test_if_none_match_create_then_conflict(object_store) -> None:
    _ok(run(object_store.put("chain.json", b"v0", if_none_match=True)))
    err = _err(run(object_store.put("chain.json", b"v1", if_none_match=True)))
    assert isinstance(err, PreconditionFailed)
    assert _ok(run(object_store.get("chain.json")))[0] == b"v0"


def test_if_match_swap_and_stale_etag_conflict(object_store) -> None:
    etag0 = _ok(run(object_store.put("chain.json", b"v0")))
    etag1 = _ok(run(object_store.put("chain.json", b"v1", if_match=etag0)))
    assert etag1 != etag0
    err = _err(run(object_store.put("chain.json", b"v2", if_match=etag0)))
    assert isinstance(err, PreconditionFailed)
    assert _ok(run(object_store.get("chain.json")))[0] == b"v1"


def test_if_match_missing_key_is_not_found(object_store) -> None:
    assert isinstance(_err(run(object_store.put("ghost", b"x", if_match="dead"))),
                      ObjectNotFound)


def test_delete_is_idempotent(object_store) -> None:
    _ok(run(object_store.put("victim", b"x")))
    _ok(run(object_store.delete("victim")))
    _ok(run(object_store.delete("victim")))
    assert isinstance(_err(run(object_store.get("victim"))), ObjectNotFound)


def test_list_is_prefix_filtered_and_sorted(object_store) -> None:
    for key in ("versions/v2/meta", "versions/v1/meta", "audit/x", "versions/v1/blob"):
        _ok(run(object_store.put(key, b"d")))
    assert _ok(run(object_store.list("versions/"))) == (
        "versions/v1/blob", "versions/v1/meta", "versions/v2/meta")
    assert _ok(run(object_store.list("zzz/"))) == ()


def test_concurrent_cas_single_winner(object_store) -> None:
    async def race() -> list:
        etag = (await object_store.put("head", b"base")).value
        return list(await asyncio.gather(
            *(object_store.put("head", f"w{i}".encode(), if_match=etag) for i in range(8))))

    results = run(race())
    assert sum(isinstance(r, Success) for r in results) == 1
    assert all(isinstance(r.error, PreconditionFailed) for r in results
               if isinstance(r, Failure))


def test_full_commit_protocol_over_backend(object_store) -> None:
    chain = AsyncBlockchainModelStore(object_store)
    v0 = _ok(_commit(chain, b"ckpt-0", "genesis"))
    v1 = _ok(_commit(chain, b"ckpt-1", "second"))
    assert (v0.counter, v1.counter, v1.parent_hash) == (0, 1, v0.content_hash)
    assert _ok(run(chain.get_head())).counter == 1
    assert _ok(run(chain.load_checkpoint(v1))) == b"ckpt-1"
    assert isinstance(_ok(run(verify_chain_detailed(chain))), ChainValid)


# --------------------------------------------------------------------------
# S3: classification and retry through the port's module
# --------------------------------------------------------------------------


def test_s3_store_imports_without_aioboto3_and_refuses_to_build(monkeypatch) -> None:
    monkeypatch.setitem(sys.modules, "aioboto3", None)
    from spectralmc_tpu_torch.storage import s3_store

    with pytest.raises(ImportError, match="aioboto3"):
        s3_store.S3ObjectStore("b")


def test_s3_throttle_classified_and_retried(s3_only) -> None:
    s3, fake = s3_only
    fake.inject("put", "hot", fake.throttle_error("SlowDown"))
    err = _err(run(s3.put("hot", b"x")))
    assert isinstance(err, Throttled) and err.code == "SlowDown"
    fake.inject("put", "hot", fake.throttle_error("RequestLimitExceeded"), times=2)
    assert _ok(run(retry_on_throttle(lambda: s3.put("hot", b"y"), base_delay=0.001)))
    assert _ok(run(s3.get("hot")))[0] == b"y"


def test_s3_network_missing_bucket_and_unknown_code_classified(s3_only) -> None:
    s3, fake = s3_only
    fake.inject("get", "flaky", fake.network_error())
    assert isinstance(_err(run(s3.get("flaky"))), NetworkError)
    assert isinstance(_err(run(type(s3)("no-such-bucket").get("k"))), BucketNotFound)
    fake.inject("put", "odd", fake.throttle_error("NotImplemented"))
    assert isinstance(_err(run(s3.put("odd", b"x"))), UnknownStoreError)


def test_s3_cas_conflict_rolls_back_artifacts(s3_only) -> None:
    s3, fake = s3_only
    chain = AsyncBlockchainModelStore(s3)
    _ok(_commit(chain, b"base", "genesis"))
    fake.inject("put", "chain.json", fake._client_error("PreconditionFailed", "PutObject"))
    assert isinstance(_err(_commit(chain, b"loser", "losing side")), NotFastForward)
    keys = _ok(run(s3.list("versions/")))
    assert len([k for k in keys if k.endswith("checkpoint.pb")]) == 1
    assert _ok(run(chain.get_head())).message == "genesis"


def test_s3_paginated_listing(s3_only) -> None:
    s3, fake = s3_only
    bucket = fake.SERVICE.buckets["faulty"]
    for i in range(2500):
        bucket[f"versions/{i:06d}"] = b"x"
    keys = _ok(run(s3.list("versions/")))
    assert len(keys) == 2500 and list(keys) == sorted(keys)


# --------------------------------------------------------------------------
# Chain bytes: the JAX package's, for the same fields
# --------------------------------------------------------------------------

RECORDS = [
    dict(counter=0, semantic_version="1.0.0", parent_hash="", content_hash="ab" * 32,
         timestamp=FIXED_TIMESTAMP, message="genesis"),
    dict(counter=1, semantic_version="1.0.1", parent_hash="ab" * 32, content_hash="cd" * 32,
         timestamp=FIXED_TIMESTAMP, message="step=2 loss=6909.23 batch=2"),
    dict(counter=7, semantic_version="1.0.7", parent_hash="cd" * 32, content_hash="ef" * 32,
         timestamp="2026-10-18T00:00:00+00:00", message="unicode: σ√Δ € \"quoted\"\n"),
]


@pytest.mark.parametrize("record", range(len(RECORDS)))
def test_record_hash_and_chain_json_bytes_equal_jax(record: int) -> None:
    port = ModelVersion(**RECORDS[record])
    jax = jchain.ModelVersion(**RECORDS[record])
    assert port.compute_hash() == jax.compute_hash()
    assert (port.version_id, port.directory_name) == (jax.version_id, jax.directory_name)
    assert tstore._chain_payload(port) == jstore._chain_payload(jax)
    assert port.model_dump() == jax.model_dump()


def test_store_layout_bytes_equal_jax(tmp_path, monkeypatch) -> None:
    """The same commits, at a fixed timestamp, leave the same objects with
    the same bytes in both packages' filesystem stores (the audit log's
    object names carry the wall clock; their contents are compared)."""
    monkeypatch.setattr(tchain, "_now_iso", lambda: FIXED_TIMESTAMP)
    monkeypatch.setattr(jchain, "_now_iso", lambda: FIXED_TIMESTAMP)
    port = AsyncBlockchainModelStore(FileSystemObjectStore(tmp_path / "port", "b"))
    jax = jstore.AsyncBlockchainModelStore(JaxFileSystemStore(tmp_path / "jax", "b"))
    for i in range(3):
        payload = f"checkpoint-{i}".encode()
        _ok(run(port.commit(payload, compute_sha256(payload), f"v{i}")))
        run(jax.commit(payload, compute_sha256(payload), f"v{i}")).expect("jax commit")

    def objects(root: Path) -> tuple[dict[str, bytes], list[bytes]]:
        files = {str(p.relative_to(root)): p.read_bytes() for p in root.rglob("*") if p.is_file()}
        audit = sorted(v for k, v in files.items() if k.startswith("audit_log/"))
        return {k: v for k, v in files.items() if not k.startswith("audit_log/")}, audit

    port_objects, port_audit = objects(tmp_path / "port" / "b")
    jax_objects, jax_audit = objects(tmp_path / "jax" / "b")
    assert port_objects == jax_objects
    assert port_audit == jax_audit and len(port_audit) == 3
    assert {k.rsplit("/", 1)[-1] for k in port_objects} == {
        "chain.json", "checkpoint.pb", "metadata.json", "content_hash.txt"}


# --------------------------------------------------------------------------
# Chains cross over
# --------------------------------------------------------------------------


def test_port_chain_verifies_and_extends_in_jax(tmp_path) -> None:
    port = AsyncBlockchainModelStore(FileSystemObjectStore(tmp_path, "x"))
    for i in range(3):
        _ok(_commit(port, f"port-{i}".encode()))
    jax = jstore.AsyncBlockchainModelStore(JaxFileSystemStore(tmp_path, "x"))
    assert run(jverify.verify_chain_detailed(jax)).expect("jax") == jverify.ChainValid(3)
    assert run(jverify.find_corruption(jax)).expect("jax") is None
    run(jax.commit(b"jax-3", compute_sha256(b"jax-3"), "jax")).expect("jax extends")
    assert _ok(run(verify_chain_detailed(port))) == ChainValid(versions=4)


def test_jax_chain_verifies_extends_and_serves_in_port(tmp_path) -> None:
    """A JAX-written checkpoint committed by the JAX store is served by the
    port's client with its provenance, and the chain takes the port's next
    version."""
    jax = jstore.AsyncBlockchainModelStore(JaxFileSystemStore(tmp_path, "y"))
    fixture = (FIXTURES / "gbm_terminal.pb").read_bytes()
    run(jax.commit(fixture, compute_sha256(fixture), "from jax")).expect("jax commit")
    port = AsyncBlockchainModelStore(FileSystemObjectStore(tmp_path, "y"))
    assert _ok(run(verify_chain_detailed(port))) == ChainValid(versions=1)

    async def serve():
        async with InferenceClient(port, PinnedMode(counter=0)) as client:
            return client.get_model()

    loaded = run(serve())
    assert loaded.config.provenance.jax_env == JaxEnv(
        jax_version="0.9.0", backend="cpu", device_kind="cpu", python_version="3.12.12")
    pricer = ttr.GbmCVNNPricer.create(loaded.config, device="cpu").expect("port serves it")
    assert np.all(np.isfinite(pricer.predict_price(_contracts()).put))
    _ok(run(commit_snapshot(port, pricer.snapshot(), "port resumes")))
    assert run(jverify.verify_chain_detailed(jax)).expect("jax") == jverify.ChainValid(2)


# --------------------------------------------------------------------------
# Behaviour: CAS, corruption, GC, serving, commits from the trainer
# --------------------------------------------------------------------------


class _RivalStore:
    """Lands a rival commit once, just before ``at``: the artifact upload
    (so the recheck sees HEAD moved) or the CAS put of ``chain.json``."""

    def __init__(self, inner, at: str) -> None:
        self._inner = inner
        self.bucket = inner.bucket
        self._at = at
        self._armed = True

    def __getattr__(self, name):
        return getattr(self._inner, name)

    async def put(self, key, data, *, if_match=None, if_none_match=False):
        trigger = key.endswith("checkpoint.pb") if self._at == "upload" else (
            key == "chain.json" and (if_match is not None or if_none_match))
        if trigger and self._armed:
            self._armed = False
            rival = AsyncBlockchainModelStore(self._inner)
            _ok(await rival.commit(b"rival", compute_sha256(b"rival"), "rival"))
        return await self._inner.put(key, data, if_match=if_match, if_none_match=if_none_match)


@pytest.mark.parametrize("at", ["upload", "cas"])
def test_stale_head_is_not_fast_forward(tmp_path, at: str) -> None:
    backend = FileSystemObjectStore(tmp_path, "cas")
    _ok(_commit(AsyncBlockchainModelStore(backend), b"base", "genesis"))
    racing = AsyncBlockchainModelStore(_RivalStore(backend, at))
    err = _err(_commit(racing, b"loser", "loser"))
    assert isinstance(err, NotFastForward)
    chain = AsyncBlockchainModelStore(backend)
    assert [v.message for v in _ok(run(chain.list_versions()))] == ["genesis", "rival"]
    assert _ok(run(verify_chain_detailed(chain))) == ChainValid(versions=2)


def test_commit_rejects_wrong_hash_and_tampered_payload(store) -> None:
    assert isinstance(_err(run(store.commit(b"x", "0" * 64, "m"))), ChecksumError)
    v0 = _ok(_commit(store, b"payload"))
    key = f"versions/{v0.directory_name}/checkpoint.pb"
    run(store.object_store.put(key, b"tampered"))
    assert isinstance(_err(run(store.load_checkpoint(v0))), ChecksumError)


def test_find_corruption_finds_a_tampered_version(store) -> None:
    versions = [_ok(_commit(store, f"c{i}".encode())) for i in range(3)]
    assert _ok(run(find_corruption(store))) is None
    key = f"versions/{versions[1].directory_name}/checkpoint.pb"
    run(store.object_store.put(key, b"tampered"))
    found = _ok(run(find_corruption(store)))
    assert isinstance(found, ChainCorrupted)
    assert (found.corruption_type, found.version_counter) == ("payload", 1)
    assert _ok(run(verify_version_completeness(store, versions[2]))) == ()


def test_verify_finds_a_broken_merkle_link(store) -> None:
    versions = [_ok(_commit(store, f"c{i}".encode())) for i in range(3)]
    key = f"versions/{versions[1].directory_name}/metadata.json"
    doc = json.loads(_ok(run(store.object_store.get(key)))[0])
    doc["parent_hash"] = "0" * 64
    run(store.object_store.put(key, json.dumps(doc).encode()))
    verdict = _ok(run(verify_chain_detailed(store)))
    assert (verdict.corruption_type, verdict.version_counter) == ("merkle_break", 1)


@pytest.mark.parametrize("defect", ["genesis_counter", "genesis_parent", "genesis_semver",
                                    "counter_gap", "merkle_break", "semver_progression"])
def test_verify_chain_links_taxonomy(defect: str) -> None:
    g = create_genesis_version("a" * 64)
    v1 = create_next_version(g, "b" * 64, "m")
    v2 = create_next_version(v1, "c" * 64, "m")
    chain = {
        "genesis_counter": (g.model_copy(update={"counter": 1}),),
        "genesis_parent": (g.model_copy(update={"parent_hash": "x"}),),
        "genesis_semver": (g.model_copy(update={"semantic_version": "2.0.0"}),),
        "counter_gap": (g, v2),
        "merkle_break": (g, v1.model_copy(update={"parent_hash": "d" * 64})),
        "semver_progression": (g, v1.model_copy(update={"semantic_version": "1.0.5"})),
    }[defect]
    verdict = verify_chain_links(chain)
    assert isinstance(verdict, ChainCorrupted) and verdict.corruption_type == defect
    assert verify_chain_links((g, v1, v2)) == ChainValid(versions=3)
    assert bump_semantic_version("1.0.9") == "1.0.10"


def test_gc_preview_execute_and_tombstones(store) -> None:
    for i in range(6):
        _ok(_commit(store, f"c{i}".encode()))
    policy = RetentionPolicy(keep_versions=2)
    preview = _ok(run(run_gc(store, policy, PreviewGC())))
    assert preview.dry_run and preview.deleted == (1, 2) and preview.bytes_freed > 0
    assert len(_ok(run(store.list_versions()))) == 6
    done = _ok(run(run_gc(store, policy, ExecuteGC())))
    assert not done.dry_run and done.deleted == (1, 2)
    assert [v.counter for v in _ok(run(store.list_versions()))] == [0, 3, 4, 5]
    assert _ok(run(verify_chain_detailed(store))) == ChainValid(versions=6)
    assert _ok(run(find_corruption(store))) is None
    kept = _ok(run(run_gc(store, RetentionPolicy(keep_versions=0, keep_min_versions=0,
                                                  protect_counters=(4,)), PreviewGC())))
    assert kept.deleted == (3, 5) and kept.protected == (0, 4)


def test_retry_schedule_and_policy() -> None:
    sched = retry_schedule(0.1, 5.0, 8)
    assert sched[:3] == (0.1, 0.2, 0.4) and max(sched) == 5.0
    throttled = Throttled(bucket="b", key="k", code="SlowDown")
    assert isinstance(decide_retry(throttled, 0, sched), RetryScheduled)
    assert isinstance(decide_retry(throttled, 8, sched), RetryExhausted)
    assert isinstance(decide_retry(PreconditionFailed("b", "k", "e"), 0, sched), RetryGiveUp)
    assert isinstance(decide_retry(ObjectNotFound("b", "k"), 0, sched), RetryGiveUp)


def _port_config() -> ttr.GbmCVNNPricerConfig:
    sim = tgbm.build_simulation_params(timesteps=8, network_size=16, batches_per_mc_run=8,
                                       mc_seed=11).expect("sim")
    cvnn = tf.build_cvnn_config(
        layers=[tf.LinearCfg(width=12, activation=tf.Activation.MODRELU)], seed=4).expect("cvnn")
    bounds = {k: tsobol.BoundSpec(lower=lo, upper=hi) for k, (lo, hi) in BOUNDS.items()}
    return ttr.GbmCVNNPricerConfig(sim=sim, bounds=bounds, cvnn=cvnn)


def _train(pricer, n: int = 2, **plan) -> np.ndarray:
    cfg = ttr.build_training_config(num_batches=n, batch_size=4, learning_rate=1e-3)
    return np.asarray(pricer.train(cfg.expect("cfg"), **plan).expect("train").losses)


def _contracts(n: int = 7) -> np.ndarray:
    gen = np.random.default_rng(3)
    lo = np.array([b[0] for b in BOUNDS.values()])
    hi = np.array([b[1] for b in BOUNDS.values()])
    return (lo + (hi - lo) * gen.random((n, 6))).astype(np.float32)


def _assert_same_prices(a, b) -> None:
    for n in (1, 7):
        pa, pb = a.predict_price(_contracts()[:n]), b.predict_price(_contracts()[:n])
        np.testing.assert_array_equal(pa.put, pb.put)
        np.testing.assert_array_equal(pa.call, pb.call)


def test_final_commit_through_make_commit_fn_resumes_and_serves(store) -> None:
    """``FinalCommit`` hands the snapshot to ``make_commit_fn``; the
    committed bytes resume and serve bit-exactly on the CPU."""
    pricer = ttr.GbmCVNNPricer.create(_port_config(), device="cpu").expect("create")
    _train(pricer, commit_plan=ttr.FinalCommit(), commit_fn=make_commit_fn(store))
    head = _ok(run(store.get_head()))
    assert head.counter == 0 and head.message.startswith("step=2 ")
    cfg = _ok(run(load_snapshot_from_checkpoint(store, head)))
    assert cfg.global_step == 2 and cfg.provenance.torch_env is not None
    restored = ttr.GbmCVNNPricer.create(cfg, device="cpu").expect("restore")
    _assert_same_prices(restored, pricer)
    twin = ttr.GbmCVNNPricer.create(pricer.snapshot(), device="cpu").expect("twin")
    np.testing.assert_array_equal(_train(restored), _train(twin))


def test_inference_pinned_and_tracking_hot_swap(store) -> None:
    pricer = ttr.GbmCVNNPricer.create(_port_config(), device="cpu").expect("create")
    _train(pricer, n=1)
    first = pricer.snapshot()
    _ok(run(commit_snapshot(store, first, "v0")))

    async def serve():
        pinned = InferenceClient(store, PinnedMode(counter=0))
        tracking = InferenceClient(store, TrackingMode(), poll_interval=0.02)
        assert isinstance(await pinned.start(), Success)
        assert isinstance(await tracking.start(), Success)
        before = tracking.get_model()
        _train(pricer, n=1)
        _ok(await commit_snapshot(store, pricer.snapshot(), "v1"))
        for _ in range(250):
            await asyncio.sleep(0.02)
            if tracking.get_model().version.counter == 1:
                break
        await tracking.stop()
        await pinned.stop()
        return pinned.get_model(), before, tracking.get_model()

    pinned, before, after = run(serve())
    assert (pinned.version.counter, before.version.counter, after.version.counter) == (0, 0, 1)
    assert (pinned.config.global_step, after.config.global_step) == (1, 2)
    _assert_same_prices(ttr.GbmCVNNPricer.create(after.config, device="cpu").expect("a"), pricer)
    snap0 = ttr.GbmCVNNPricer.create(first, device="cpu").expect("first")
    _assert_same_prices(ttr.GbmCVNNPricer.create(pinned.config, device="cpu").expect("p"), snap0)


def test_inference_refusals(store) -> None:
    assert isinstance(_err(run(InferenceClient(store, TrackingMode()).start())), VersionNotFound)
    _ok(_commit(store, b"not a checkpoint"))
    assert isinstance(_err(run(InferenceClient(store, PinnedMode(counter=3)).start())),
                      VersionNotFound)
    assert _err(run(InferenceClient(store, PinnedMode(counter=0)).start())).key.startswith("v0")
    with pytest.raises(ValueError):
        PinnedMode(counter=-1)


def test_commit_failure_does_not_kill_training(tmp_path) -> None:
    class Refusing:
        bucket = "r"

        async def get(self, key):
            return Failure(UnknownStoreError(bucket="r", key=key, reason="down"))

    pricer = ttr.GbmCVNNPricer.create(_port_config(), device="cpu").expect("create")
    commit_fn = make_commit_fn(AsyncBlockchainModelStore(Refusing()))
    losses = _train(pricer, n=1, commit_plan=ttr.FinalCommit(), commit_fn=commit_fn)
    assert np.all(np.isfinite(losses)) and pricer.global_step == 1


# --------------------------------------------------------------------------
# The CLI: exit codes 0 ok, 1 problem found, 2 usage or backend error
# --------------------------------------------------------------------------

BUCKET = "clitest"


def _make_chain(root: Path, n: int = 4) -> None:
    chain = AsyncBlockchainModelStore(FileSystemObjectStore(str(root), BUCKET))
    for i in range(n):
        _ok(_commit(chain, f"checkpoint-{i}".encode(), f"v{i}"))


def _main(root: Path, *argv: str) -> int:
    return cli.main(["--root", str(root), "--bucket", BUCKET, *argv])


def test_cli_verify_list_and_inspect(tmp_path, capsys) -> None:
    _make_chain(tmp_path)
    assert _main(tmp_path, "verify") == 0 and "chain valid (4 versions)" in capsys.readouterr().out
    assert _main(tmp_path, "list-versions") == 0
    out = capsys.readouterr().out
    assert len([line for line in out.splitlines() if line.startswith("v")]) == 4
    assert "HEAD: v0000000003" in out
    assert _main(tmp_path, "inspect", "2") == 0
    record = json.loads(capsys.readouterr().out)
    assert record["counter"] == 2 and record["missing_artifacts"] == []
    assert _main(tmp_path, "inspect", "99") == 2


def test_cli_gc_preview_refusal_and_run(tmp_path, capsys) -> None:
    _make_chain(tmp_path, n=6)
    assert _main(tmp_path, "gc-preview", "--keep", "2") == 0
    assert "would delete: [1, 2]" in capsys.readouterr().out
    checkpoints = f"{BUCKET}/versions/*/checkpoint.pb"
    assert _main(tmp_path, "gc-run", "--keep", "2") == 2
    assert len(list(tmp_path.glob(checkpoints))) == 6
    assert _main(tmp_path, "gc-run", "--keep", "2", "--yes") == 0
    assert len(list(tmp_path.glob(checkpoints))) == 4
    assert _main(tmp_path, "verify") == 0 and _main(tmp_path, "find-corruption") == 0


def test_cli_problems_exit_one(tmp_path, capsys) -> None:
    _make_chain(tmp_path, n=3)
    victim = sorted(tmp_path.glob(f"{BUCKET}/versions/*/checkpoint.pb"))[1]
    victim.write_bytes(b"tampered")
    assert _main(tmp_path, "find-corruption") == 1
    assert "CORRUPTED [payload] at v1" in capsys.readouterr().out
    meta = sorted(tmp_path.glob(f"{BUCKET}/versions/*/metadata.json"))[2]
    doc = json.loads(meta.read_text())
    doc["parent_hash"] = "0" * 64
    meta.write_text(json.dumps(doc))
    assert _main(tmp_path, "verify") == 1
    assert "CORRUPTED [merkle_break] at v2" in capsys.readouterr().out


def test_cli_tensorboard_log_is_refused_with_its_queue_item(tmp_path, capsys,
                                                            monkeypatch) -> None:
    """``tensorboard-log`` writes the chain's history (once refused while
    ``utils/`` was not ported): one text entry a version, through the gated
    writer, here a recording one."""
    import spectralmc_tpu_torch.utils.tensorboard_writer as tbw

    texts: list[str] = []

    class Recorder:
        def add_text(self, tag: str, text: str, step: int) -> None:
            texts.append(tag)

        def add_scalar(self, tag: str, value: float, step: int) -> None:
            pass

        def flush(self) -> None:
            pass

        def close(self) -> None:
            pass

    monkeypatch.setattr(tbw, "_make_writer", lambda logdir: Recorder())
    _make_chain(tmp_path, n=1)
    assert _main(tmp_path, "tensorboard-log", "--logdir", str(tmp_path / "tb")) == 0
    assert len(texts) == 1
    assert f"logged 0 versions to {tmp_path / 'tb'}" in capsys.readouterr().out


def test_cli_runs_as_a_module(tmp_path) -> None:
    _make_chain(tmp_path, n=2)

    def cli_run(*argv: str) -> subprocess.CompletedProcess[str]:
        return subprocess.run(
            [sys.executable, "-m", "spectralmc_tpu_torch.storage", "--root", str(tmp_path),
             "--bucket", BUCKET, *argv], capture_output=True, text=True, cwd=REPO, timeout=120)

    ok = cli_run("verify")
    assert ok.returncode == 0 and "chain valid (2 versions)" in ok.stdout, ok.stderr
    assert cli_run("no-such-command").returncode == 2
    logged = cli_run("tensorboard-log", "--logdir", str(tmp_path / "tb"))
    if importlib.util.find_spec("tensorboard") is None:  # the writer's gate
        assert logged.returncode == 2 and "tensorboard package" in logged.stderr
    else:  # the payloads are not checkpoints: text entries only
        assert logged.returncode == 0, logged.stderr
        assert "logged 0 versions" in logged.stdout and any((tmp_path / "tb").iterdir())
