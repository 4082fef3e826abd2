"""One process a card: the port's ``launch.cluster`` and the row-sharded
match stack across ``torch.distributed`` ranks.

* ``detect_environment`` and ``_first_slurm_node`` against
  ``repro.launch.cluster``'s (which imports JAX only inside its
  functions).
* One shared run of ``run_cpu_demo(2, 4)``: two gloo ranks of 4 CPU
  shards each and the port's one-process 8-shard baseline, spawned
  together.  Counterparts of every ``TestCpuDistributed`` case of
  ``tests/test_match_multihost.py``, each stage also held to the JAX
  package's one-device engine on the same workload (computed here while
  the workers run; the reference's own multi-process demo fails in its
  hot-row gather, so it cannot serve).  Added stages: a row subset all
  on rank 0's shards (rank 1 joins nothing), a top-k whose ties span
  both ranks, a batched tensor-core top-k, and the refusal of per-row
  and batched SWAR queries on both ranks.
* The backend rule: NCCL raises where the ranks outnumber the cards.
* A ``gpu`` case runs the demo on the card (skipped here).
"""

from __future__ import annotations

import ast
import inspect
import textwrap
import threading
import types

import numpy as np
import pytest
import torch

from repro_torch.launch import cluster

N_PROCESSES = 2
LOCAL_DEVICES = 4
REFERENCE_STAGES = (
    "threshold_scan", "threshold_filtered", "iupac_wildcard", "topk",
    "best", "threshold_after_append", "topk_after_append",
    "threshold_after_tombstone", "threshold_after_compact",
    "best_after_compact")
STAGES = REFERENCE_STAGES + ("threshold_subset", "topk_ties",
                             "topk_batched_mxu")
RESULT_KEYS = ("best_locs", "best_scores", "hits", "topk_rows",
               "topk_scores")

ENVIRONMENTS = [
    {},
    {"REPRO_COORDINATOR": "10.0.0.1:1234", "REPRO_PROCESS_ID": "3",
     "REPRO_NUM_PROCESSES": "8"},
    {"REPRO_COORDINATOR": "host:99"},
    {"SLURM_JOB_NUM_NODES": "1", "SLURM_NODELIST": "solo",
     "SLURM_PROCID": "0"},
    {"SLURM_JOB_NUM_NODES": "4", "SLURM_NODELIST": "zz[1-4]",
     "SLURM_STEP_NODELIST": "a[001-004],b02", "SLURM_PROCID": "2"},
    {"SLURM_JOB_NUM_NODES": "2", "SLURM_NODELIST": "n7,n8",
     "SLURM_PROCID": "1", "REPRO_PORT": "9999"},
]


@pytest.mark.parametrize("env", ENVIRONMENTS)
def test_detect_environment_matches_reference(env):
    jcluster = pytest.importorskip("repro.launch.cluster")
    want = jcluster.detect_environment(env)
    got = cluster.detect_environment(env)
    assert (got.coordinator, got.process_id, got.process_count,
            got.is_coordinator) == (want.coordinator, want.process_id,
                                    want.process_count, want.is_coordinator)


@pytest.mark.parametrize("nodelist", ["", "solo", "a[001-004],b02",
                                      "gpu[7,9-12]", "x1,x2"])
def test_first_slurm_node_matches_reference(nodelist):
    jcluster = pytest.importorskip("repro.launch.cluster")
    assert (cluster._first_slurm_node(nodelist)
            == jcluster._first_slurm_node(nodelist))


def test_cpu_process_env_names_a_gloo_rank():
    env = cluster.cpu_process_env(1, 2, "127.0.0.1:29500", local_devices=3)
    assert cluster.detect_environment(env) == cluster.HostInfo(
        "127.0.0.1:29500", 1, 2)
    assert env["REPRO_SHARD_DEVICES"] == "cpu,cpu,cpu"
    assert env["REPRO_BACKEND"] == "gloo"


def jax_one_device() -> dict:
    """The demo's stages on the JAX package's one-device engine."""
    jm = pytest.importorskip("repro.match")
    data = cluster.demo_inputs()
    corpus = jm.PackedCorpus(data["frags"], capacity=2048)
    engine = jm.MatchEngine(corpus, record_runtimes=False)
    compiled = {name: engine.compile(q)
                for name, q in cluster.demo_queries(jm, data).items()}
    return cluster.demo_stages(engine, compiled, data)


@pytest.fixture(scope="module")
def demo():
    """One 2-rank gloo run + the 1-process baseline (spawned together),
    and the JAX one-device answers computed meanwhile."""
    box: dict = {}

    def spawn():
        try:
            box["demo"] = cluster.run_cpu_demo(
                n_processes=N_PROCESSES, local_devices=LOCAL_DEVICES,
                timeout=300)
        except BaseException as e:       # re-raised on the test's thread
            box["error"] = e
    worker = threading.Thread(target=spawn)
    worker.start()
    try:
        jax_results = jax_one_device()
    finally:
        worker.join(timeout=400)
    assert not worker.is_alive()
    if "error" in box:
        raise box["error"]
    box["demo"]["jax"] = jax_results
    return box["demo"]


class TestCpuDistributed:
    def test_gate_bit_identical(self, demo):
        assert demo["identical"], demo["mismatches"]
        assert demo["backend"] == "gloo"
        assert demo["n_shards"] == N_PROCESSES * LOCAL_DEVICES

    @pytest.mark.parametrize("stage", STAGES)
    def test_stage_matches_single_process(self, demo, stage):
        single = demo["single"]["results"][stage]
        for run in demo["multiprocess"]:
            # The ring count of the joined payload is the same at any
            # process count, so even the byte ledger agrees.
            assert run["results"][stage] == single, stage

    @pytest.mark.parametrize("stage", STAGES)
    def test_stage_matches_jax_one_device(self, demo, stage):
        want = demo["jax"][stage]
        got = demo["multiprocess"][0]["results"][stage]
        for key in RESULT_KEYS:
            assert (key in want) == (key in got), (stage, key)
            if key in want:
                assert got[key] == want[key], (stage, key)
        if want["strategy"] == got["strategy"]:
            assert got.get("n_survivors") == want.get("n_survivors")

    def test_processes_agree(self, demo):
        # SPMD contract: every rank computes the same replicated answer --
        # including the transfer ledger.
        runs = demo["multiprocess"]
        assert runs[1]["results"] == runs[0]["results"]
        assert [r["local_shards"] for r in runs] == [[0, 1, 2, 3],
                                                     [4, 5, 6, 7]]
        assert all(r["owners"] == [0] * 4 + [1] * 4 for r in runs)

    def test_merges_device_side(self, demo):
        for run in (*demo["multiprocess"], demo["single"]):
            assert run["merge_path"] == "device"
            assert run["collective_bytes"] > 0
            assert run["n_collectives"] > 0
        runs = demo["multiprocess"]
        assert ({(r["n_collectives"], r["collective_bytes"]) for r in runs}
                == {(demo["single"]["n_collectives"],
                     demo["single"]["collective_bytes"])})

    def test_zero_false_negatives(self, demo):
        res = demo["multiprocess"][0]["results"]
        hits = {(r, l) for r, l, _ in res["threshold_scan"]["hits"]}
        assert {(3, 5), (500, 5), (1021, 5), (11, 10)} <= hits
        grown = {(r, l) for r, l, _ in res["threshold_after_append"]["hits"]}
        assert (1024 + 40, 20) in grown

    def test_tombstone_then_compact(self, demo):
        res = demo["multiprocess"][0]["results"]
        after_tomb = {r for r, _, _ in
                      res["threshold_after_tombstone"]["hits"]}
        assert 3 not in after_tomb and 500 not in after_tomb
        after_comp = {(r, l) for r, l, _ in
                      res["threshold_after_compact"]["hits"]}
        # ids above the two reclaimed rows shift down.
        assert {(10, 10), (1019, 5), (1062, 20)} <= after_comp

    def test_pack_counters_flat_per_host(self, demo):
        # Each rank packs only its own shards, once a form, through the
        # whole append/tombstone/compact sequence.
        for run in demo["multiprocess"]:
            assert run["pack_counts"]["swar"] == 1
            assert run["pack_counts"]["onehot"] == 1
            assert run["pack_counts"]["signatures"] == 1
            assert run["pack_counts"] == demo["single"]["pack_counts"]


def test_subset_on_rank_zero_joins_across_ranks(demo):
    """Every row of the subset sits on rank 0's shards: rank 1 launches
    nothing and still returns the same hits."""
    subset = cluster.demo_inputs()["subset"]
    assert np.all(subset % 8 < 4)
    runs = demo["multiprocess"]
    hits = runs[1]["results"]["threshold_subset"]["hits"]
    assert {(3, 0), (11, 0)} <= {(r, q) for r, _, q, _ in hits}
    assert {r for r, _, _, _ in hits} <= set(subset.tolist())
    assert hits == runs[0]["results"]["threshold_subset"]["hits"]


def test_topk_ties_span_both_ranks(demo):
    """Equal best scores on rows of both ranks' shards come out in row
    order, as one process orders them."""
    res = demo["multiprocess"][0]["results"]["topk_ties"]
    rows, scores = res["topk_rows"], res["topk_scores"]
    owners = {}
    for r, s in zip(rows, scores):
        owners.setdefault(s, set()).add((r % 8) // LOCAL_DEVICES)
    assert any(o == {0, 1} for o in owners.values())
    for s in set(scores):
        tied = [r for r, t in zip(rows, scores) if t == s]
        assert tied == sorted(tied)


def reference_refusal(mode: str) -> str:
    """The reference's message for a per-row or batched SWAR query on a
    multi-process mesh, rendered from its source."""
    jengine = pytest.importorskip("repro.match.engine")
    src = textwrap.dedent(inspect.getsource(
        jengine.MatchEngine._swar_chunk_mp))
    node = next(n for n in ast.walk(ast.parse(src))
                if isinstance(n, ast.Raise))
    code = compile(ast.Expression(node.exc.args[0]), "<reference>", "eval")
    return eval(code, {"plan": types.SimpleNamespace(mode=mode)})


@pytest.mark.parametrize("mode", ["per_row", "batched"])
def test_swar_layouts_refused_on_every_rank(demo, mode):
    for run in demo["multiprocess"]:
        assert run["refusals"][mode] == reference_refusal(mode)
    assert demo["single"]["refusals"] == {}


def test_provenance_reads_the_group(demo):
    for run in demo["multiprocess"]:
        assert run["provenance"] == {"n_processes": N_PROCESSES,
                                     "n_hosts": 1}
    assert demo["single"]["provenance"] == {"n_processes": 1, "n_hosts": 1}


def test_indivisible_mesh_refused(demo):
    for run in demo["multiprocess"]:
        assert "does not divide over 2 processes" in \
            run["refusals"]["indivisible_mesh"]


def test_backend_rule():
    info = cluster.HostInfo("127.0.0.1:1", 0, 2)
    assert cluster.pick_backend(info, None, "cpu") == "gloo"
    assert cluster.pick_backend(info, "gloo", None) == "gloo"
    with pytest.raises(ValueError, match="backend must be one of"):
        cluster.pick_backend(info, "mpi", "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cluster.pick_backend(info, None, None)   # the card, none here


def test_initialize_nccl_raises_where_ranks_outnumber_cards():
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    info = cluster.HostInfo("127.0.0.1:1", 0, max(2, cards + 1))
    with pytest.raises(RuntimeError, match="NCCL refuses two ranks"):
        cluster.initialize(info, backend="nccl", timeout_s=5)
    assert not torch.distributed.is_initialized()


RANK_1_OF_2 = {"REPRO_COORDINATOR": "127.0.0.1:1", "REPRO_PROCESS_ID": "1",
               "REPRO_NUM_PROCESSES": "2"}
SLURM_NODE_2_OF_2 = {"SLURM_JOB_NUM_NODES": "2", "SLURM_NODELIST": "n[1-2]",
                     "SLURM_PROCID": "1", "SLURM_LOCALID": "0"}


@pytest.mark.parametrize("env, cards, backend, want", [
    (RANK_1_OF_2, 4, "gloo", ["cuda:2", "cuda:3"]),     # one host
    (RANK_1_OF_2, 4, "nccl", ["cuda:2", "cuda:3"]),
    (SLURM_NODE_2_OF_2, 2, "nccl", ["cuda:0", "cuda:1"]),  # a node a rank
    (RANK_1_OF_2, 3, "gloo", None),                     # too few cards
])
def test_default_row_mesh_takes_this_ranks_cards(monkeypatch, env, cards,
                                                 backend, want):
    """``make_row_mesh(4)`` on rank 1 of a 2-rank group (the group and the
    cards patched in): this rank's 2 cards from ``local_rank * 2``, the
    rule ``initialize`` uses; under NCCL the first becomes current."""
    from repro_torch.launch import mesh as tmesh
    for key in list(RANK_1_OF_2) + list(SLURM_NODE_2_OF_2):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    current = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    monkeypatch.setattr(cluster, "process_count", lambda: 2)
    monkeypatch.setattr(cluster, "process_index", lambda: 1)
    monkeypatch.setattr(torch.distributed, "get_backend", lambda: backend)

    def all_gather_object(out, obj):
        out[:] = [[f"rank0/{i}" for i in range(len(obj))], obj]
    monkeypatch.setattr(torch.distributed, "all_gather_object",
                        all_gather_object)
    if want is None:
        with pytest.raises(RuntimeError, match="CUDA devices 2..3"):
            tmesh.make_row_mesh(4)
        return
    m = tmesh.make_row_mesh(4)
    assert m.devices == (None, None, *map(torch.device, want))
    assert m.local_shards == (2, 3) and m.device == torch.device(want[0])
    assert [m.owner(s) for s in range(4)] == [0, 0, 1, 1]
    assert (m.rank, m.world, m.backend) == (1, 2, backend)
    assert current == ([torch.device(want[0])] if backend == "nccl" else [])


def test_run_demo_defaults_to_the_card():
    """``run_demo`` without a device is the card's: here it raises before
    spawning anything; ``run_cpu_demo`` names the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        cluster.run_demo()
    assert cluster.host_count() == 1


def test_initialize_one_process_is_a_noop():
    info = cluster.initialize(cluster.HostInfo(None, 0, 1), backend="nccl")
    assert info.process_count == 1
    assert not torch.distributed.is_initialized()
    assert cluster.process_count() == 1 and cluster.process_index() == 0


@pytest.mark.gpu
def test_card_demo_equals_one_process():
    """The demo on the card: NCCL with a card a rank, else both ranks on
    ``cuda:0`` under a gloo named here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    backend = None if torch.cuda.device_count() >= N_PROCESSES else "gloo"
    out = cluster.run_demo(N_PROCESSES, LOCAL_DEVICES, device="cuda",
                           backend=backend, timeout=600)
    assert out["identical"], out["mismatches"]
    assert out["backend"] == (backend or "nccl")
    for run in out["multiprocess"]:
        assert run["pack_counts"] == out["single"]["pack_counts"]
