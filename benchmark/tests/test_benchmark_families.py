"""Model families (benchmark/families/): the registry finds them by name; the
gcn family reads on a tiny graph exactly what the two-layer harness read
before it; a three-layer GCN and a stand-in family enter a copy of the
benchmark as new files only, and drive ``run.main`` to a result on the CPU."""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import pytest
import torch

from benchmark import compare, data, registry, run, synth
from benchmark.run import job_seed
from benchmark.tests.conftest import BENCH_DIR, TINY_GRAPH, run_tiny

gcn = registry.family("gcn")

MODEL = {"hidden_dim": 16, "dropout": 0.5, "learning_rate": 0.01, "weight_decay": 5e-4}
# the two-layer harness's readings before the families (benchmark/program.py,
# reference.py, compare.py and roofline.py as they stood), on a 500-node
# graph with ATen on one thread: the compared numbers, the reference's
# losses (each step's training loss, the validation losses, the test loss)
# and the least seconds of a 37-epoch job by part
RECORDED = {
    "dense": {
        "numbers": {"loss_gap": 3.51016029059213e-07, "grad1_gap": 7.440244238184241e-08,
                    "change_gap": 6.812290987003734e-06, "grad1_diff": 1.3480703371065602e-07,
                    "grad1_l0_gap": 4.432682836787179e-08, "grad1_l0_diff": 9.9274969573635e-08,
                    "mask_z": 1.8204442391564313},
        "ref_losses": [1.4490197896957397, 1.4181245565414429, 1.3957895040512085,
                       1.3994959592819214, 1.3809971809387207, 1.3644555807113647,
                       1.3584483861923218],
        "least_s": {"aggregation": 3.7059725373134327e-06, "layer0": 1.4519402985074626e-06,
                    "total": 5.1579128358208955e-06}},
    "sparse": {
        "numbers": {"loss_gap": 2.6289806381710285e-07, "grad1_gap": 5.373220190954753e-09,
                    "change_gap": 6.8179255584458885e-06, "grad1_diff": 7.247767489292652e-08,
                    "grad1_l0_gap": 4.3877678746399664e-08,
                    "grad1_l0_diff": 1.1650201208946895e-07, "mask_z": 1.676650046517178},
        "ref_losses": [1.4333178997039795, 1.424206256866455, 1.389887809753418,
                       1.4000349044799805, 1.3818000555038452, 1.3647171258926392,
                       1.360329031944275],
        "least_s": {"aggregation": 3.7059725373134327e-06, "layer0": 5.27689552238806e-07,
                    "total": 4.233662089552239e-06}},
    "early_stopping": {
        "numbers": {"loss_gap": 3.51016029059213e-07, "grad1_gap": 7.485369620598266e-08,
                    "change_gap": 6.861170647363801e-06, "grad1_diff": 1.2217520124876871e-07,
                    "grad1_l0_gap": 4.5272792452954235e-08,
                    "grad1_l0_diff": 1.0717784959744229e-07, "mask_z": 1.8204442391564313},
        "ref_losses": [1.4490197896957397, 1.4181245565414429, 1.3957895040512085,
                       1.3994959592819214, 1.3809971809387207, 1.3644555807113647,
                       1.3584483861923218],
        "least_s": {"aggregation": 4.15931223880597e-06, "layer0": 2.1397014925373136e-06,
                    "total": 6.299013731343284e-06}},
}
FORMS = {"dense": ("dense", 0), "sparse": ("sparse", 0), "early_stopping": ("dense", 10)}


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_a_configuration_without_a_family_is_a_gcn():
    for name in ("gcn2-reddit", "gcn2-pubmed"):
        config = registry.config(name)
        assert "family" not in config["model"]
        assert registry.family_name(config) == "gcn"
    assert registry.family_name({"model": {"family": "gat"}}) == "gat"
    assert set(registry.FAMILY_API) <= set(dir(gcn))


def test_an_unknown_family_is_refused_by_name():
    with pytest.raises(FileNotFoundError, match="no-such-family"):
        registry.family("no-such-family")
    with pytest.raises(ValueError):
        registry.family("../run")


@pytest.mark.parametrize("form", list(FORMS))
def test_gcn_reads_as_the_two_layer_harness_did(form, one_thread):
    feature_matmul, es = FORMS[form]
    d = synth.make_synthetic(synth.spec_for(500, 2500, 4, 32, nnz_per_node=6, num_val=100,
                                            num_test=100), seed=0)
    cfg = {"model": MODEL, "graphsum_backend": "ell", "compute_dtype": "float32",
           "param_dtype": "float32"}
    traffic = {"feature_matmul": feature_matmul, "epochs": 20, "early_stopping": es}
    prep = gcn.prepare(cfg, traffic, d, "cpu")
    seed = job_seed(2**31 + 7, "check")
    got = gcn.check_steps(prep, d, seed)
    ref = gcn.follow(gcn.reference_inputs(d, cfg, traffic, "cpu"), cfg, seed, got)
    want = RECORDED[form]
    assert gcn.numbers(got, ref) == want["numbers"]
    assert [*ref.train_loss, *ref.val_loss, ref.test_loss] == want["ref_losses"]
    work = gcn.job_work(gcn.shapes(prep, d, cfg, traffic), 37, es > 0)
    assert {k: work[k].least_s("float32") for k in want["least_s"]} == want["least_s"]


def _hashes(root) -> dict[str, str]:
    out = {}
    for base, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x not in (".cache", "__pycache__")]
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


class BenchCopy:
    """A copy of the benchmark (BENCHMARK.json and benchmark/) to which a
    test adds a configuration as new files and entries only."""

    def __init__(self, root):
        self.root = root
        self.bench = root / "benchmark"
        shutil.copytree(BENCH_DIR, self.bench,
                        ignore=shutil.ignore_patterns(".cache", "__pycache__"))
        shutil.copy(os.path.join(os.path.dirname(BENCH_DIR), "BENCHMARK.json"), root)
        self.spec = json.loads((root / "BENCHMARK.json").read_text())
        self.hashes = _hashes(self.bench)

    def write(self, kind: str, name: str, body) -> None:
        path = self.bench / kind / name
        assert not path.exists(), path
        path.write_text(body if isinstance(body, str) else json.dumps(body))

    def add_cell(self, cell: str, config: dict, traffic: dict, limits: dict,
                 metrics=("epoch_ms", "epoch_mfu", "syncs_per_epoch", "prepare_s")) -> None:
        """New config (unless an earlier cell added it), traffic and workload
        files, and the cell's entries in BENCHMARK.json: its configuration,
        its cell, and its name in the ``workloads`` list of each of ``metrics``."""
        if not (self.bench / "configs" / f"{config['name']}.json").exists():
            self.write("configs", f"{config['name']}.json", config)
        self.write("traffic", f"{cell}.json", traffic)
        self.write("workloads", f"{cell}.json", {"config": config["name"], "traffic": cell,
                                                  "why": "a test", "limits": limits})
        spec = json.loads((self.root / "BENCHMARK.json").read_text())
        if all(c["name"] != config["name"] for c in spec["configs"]):
            spec["configs"].append({"name": config["name"], "source": "a test",
                                    "file": f"benchmark/configs/{config['name']}.json",
                                    "reduced": [], "why": "a test"})
        spec["workloads"].append({"name": cell, "config": config["name"], "traffic": cell,
                                  "chips": 1, "why": "a test"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if m["name"] in metrics:
                m["workloads"].append(cell)
        (self.root / "BENCHMARK.json").write_text(json.dumps(spec, indent=2))

    def assert_only_added(self) -> None:
        """No file that was in the copy changed, and BENCHMARK.json less the
        added cells' entries is the copied one."""
        now = _hashes(self.bench)
        assert {k: now.get(k) for k in self.hashes} == self.hashes
        spec = json.loads((self.root / "BENCHMARK.json").read_text())
        old_cells = {w["name"] for w in self.spec["workloads"]}
        old_configs = {c["name"] for c in self.spec["configs"]}
        spec["configs"] = [c for c in spec["configs"] if c["name"] in old_configs]
        spec["workloads"] = [w for w in spec["workloads"] if w["name"] in old_cells]
        for m in spec["end_to_end"] + spec["per_layer"]:
            if "workloads" in m:
                m["workloads"] = [w for w in m["workloads"] if w in old_cells]
        assert spec == self.spec


@pytest.fixture
def bench_copy(tmp_path, monkeypatch):
    copy = BenchCopy(tmp_path / "checkout")
    monkeypatch.setattr(registry, "BENCH_DIR", str(copy.bench))
    monkeypatch.setattr(registry, "ROOT", str(copy.root))
    monkeypatch.setattr(data, "CACHE_DIR", str(tmp_path / "data"))
    return copy


def _pubmed_limits() -> dict:
    with open(os.path.join(BENCH_DIR, "workloads", "pubmed-200ep.json")) as f:
        return json.load(f)["limits"]


def _three_layer_config() -> dict:
    with open(os.path.join(BENCH_DIR, "configs", "gcn2-pubmed.json")) as f:
        config = json.load(f)
    config["name"] = "gcn3-tiny"
    config["model"]["layers"] = 3
    del config["model"]["hidden_dim"]
    config["model"]["hidden_dims"] = [64, 64]
    config["graph"].update(TINY_GRAPH)
    return config


TRAFFIC = {"feature_matmul": "dense", "epochs": 6, "early_stopping": 0, "trace_jobs": 2,
           "job_pool": 8}


def test_a_three_layer_gcn_enters_as_new_files(bench_copy, capsys):
    bench_copy.add_cell("gcn3-tiny-cell", _three_layer_config(), TRAFFIC, _pubmed_limits())
    rc, line, err = run_tiny(capsys, cell="gcn3-tiny-cell")
    assert rc == 0 and line["correct"] is True, (line, err[-2000:])
    assert set(line["metrics"]) == {"setup_s", "epoch_ms", "peak_mem_gib"}
    rc, traced, err = run_tiny(capsys, trace=1, cell="gcn3-tiny-cell")
    assert rc == 0 and traced["correct"] is True, err[-2000:]
    assert {"epoch_mfu", "syncs_per_epoch", "prepare_s"} <= set(traced["metrics"])
    bench_copy.assert_only_added()


def test_three_layer_masks_and_faults(bench_copy):
    """At two hidden layers the program's masks read back one a layer, the
    sound reference passes the cell's limits, and faults planted in the
    reference read not correct ('dropout_rate', p + 0.05, reads about
    0.1·sqrt(n) deviations: 6 at this graph's 3,600 nnz, under the limit
    that pubmed's size sets)."""
    config, limits = _three_layer_config(), _pubmed_limits()
    bench_copy.add_cell("gcn3-tiny-cell", config, TRAFFIC, limits)
    family = registry.family(registry.family_name(config))
    graph, _ = data.load_graph(config)
    prep = family.prepare(config, TRAFFIC, graph, "cpu")
    seed = job_seed(2**31 + 3, "check")
    got = family.check_steps(prep, graph, seed)
    n = int(graph["num_nodes"])
    assert len(got.masks) == family.STEPS
    for step in got.masks:
        assert [tuple(m.shape) for m in step[1:]] == [(n, 64), (n, 64)]
        assert all(0.05 < float(m.float().mean()) < 0.45 for m in step[1:])
    inputs = family.reference_inputs(graph, config, TRAFFIC, "cpu")
    sound = family.numbers(got, family.follow(inputs, config, seed, got))
    assert compare.judge(sound, limits), sound
    ref = family.follow(inputs, config, seed, got)
    for fault in family.FAULTS:
        if fault == "dropout_rate":
            continue
        bad = family.numbers(family.follow(inputs, config, seed, got, fault=fault), ref)
        assert not compare.judge(bad, limits), (fault, bad)
    bench_copy.assert_only_added()


TOY = '''"""A stand-in family: a job is one dot product of ones."""
import torch

from benchmark.roofline import Work

NUMBERS = ("toy_gap",)
FAULTS = ("off_by_one",)
CONTROL = "float32"


def prepare(config, traffic, data, device):
    return {"n": int(data["num_nodes"]), "epochs": int(traffic["epochs"]), "device": device}


def run_job(prep, seed):
    x = torch.ones(prep["n"], device=prep["device"])
    return prep["epochs"], bool(torch.isfinite(x @ x))


def check_steps(prep, data, seed):
    return float(torch.ones(prep["n"]).sum())


def reference_inputs(data, config, traffic, device):
    return int(data["num_nodes"])


def follow(inputs, config, seed, readings, precision="float32", fault=None):
    return float(inputs) + (1.0 if fault else 0.0)


def numbers(prog, ref):
    return {"toy_gap": abs(prog - ref)}


def shapes(prep, data, config, traffic):
    return prep["n"]


def job_work(shapes, epochs, early_stopping):
    return {"total": Work(bytes=8.0 * shapes * epochs)}
'''


def test_a_stand_in_family_runs_without_an_edit(bench_copy, capsys):
    bench_copy.write("families", "toy.py", TOY)
    config = dict(_three_layer_config(), name="toy-tiny", model={"family": "toy"})
    bench_copy.add_cell("toy-cell", config, TRAFFIC, {"toy_gap": 0.5})
    rc, line, err = run_tiny(capsys, cell="toy-cell")
    assert rc == 0 and line["correct"] is True, err[-2000:]
    assert list(line["checks"]) == ["toy_gap", "failed_jobs"]
    rc, traced, err = run_tiny(capsys, trace=1, cell="toy-cell")
    assert rc == 0 and traced["metrics"]["epoch_mfu"]["value"] > 0, err[-2000:]
    # a cell whose limits name other numbers than its family's is refused, by name
    bench_copy.add_cell("toy-other", config, TRAFFIC, {"loss_gap": 1.0})
    rc, line, err = run_tiny(capsys, cell="toy-other")
    assert rc != 0 and line is None
    assert "loss_gap" in err and "toy_gap" in err and "'toy'" in err
    bench_copy.assert_only_added()


def test_readers_take_the_familys_parts_by_name():
    """``Context.least_s`` sums each job's named parts' least times; a part
    no job gives reads None, and so does a context without ``job_work``."""
    from benchmark.roofline import Work

    work = {"total": Work(bytes=3.35e12), "aggregation": Work(flops=67e12)}
    ctx = run.Context(None, True, [1, 2], None, False, 0.0,
                      job_work=lambda e: {k: v * e for k, v in work.items()})
    assert ctx.least_s(("total",)) == 3.0
    assert ctx.least_s(("aggregation", "layer0_spmm")) == 3.0
    assert ctx.least_s(("layer0_spmm",)) is None
    assert run.Context(None, True, [1], None, False, 0.0).least_s(("total",)) is None
