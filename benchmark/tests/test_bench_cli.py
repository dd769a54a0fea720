"""Arguments, the result's line, and the refusals."""
import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, SMALL_CLIP, SMALL_SET, small_cell
from fvbench import cells, cli, registry, trace

RUN = os.path.join(BENCH, "run.py")


def test_arguments():
    a = cli.parse(["--workload", "4k-clip", "--seed", str(2**31 + 17), "--seconds", "30",
                   "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == ("4k-clip", 2**31 + 17, 30.0, 1)
    assert a.worker_rank is None
    with pytest.raises(SystemExit):
        cli.parse(["--workload", "4k-clip", "--seed", "1", "--seconds", "3", "--trace", "2"])
    with pytest.raises(SystemExit):
        cli.parse(["--seed", "1", "--seconds", "3"])


def test_banned_modules_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "fovvideovdp_tpu_torch_lookalike", sys)
    assert cli.banned_modules() == []
    monkeypatch.setitem(sys.modules, "fovvideovdp_tpu.core", sys)
    assert cli.banned_modules() == ["fovvideovdp_tpu"]


def test_no_card_no_result(tmp_path):
    """Without a card the run exits non-zero and prints nothing on stdout."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    r = subprocess.run([sys.executable, RUN, "--workload", "kadid-batch", "--seed", "3",
                        "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                       cwd=os.path.dirname(BENCH), timeout=120)
    assert r.returncode != 0 and r.stdout == ""
    assert "needs 1 CUDA card" in r.stderr


def test_outside_a_checkout_no_result(tmp_path):
    """A directory with only BENCHMARK.json and benchmark/ exits non-zero."""
    import shutil
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json"), tmp_path)
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "4k-clip", "--seed",
                        "3", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                       cwd=tmp_path, timeout=120)
    assert r.returncode != 0 and r.stdout == ""


def _line(res):
    line = json.loads(json.dumps(res))
    assert list(line)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    for v in line["compared"].values():
        assert set(v) == {"value", "limit"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    return line


def test_result_line_schema_untraced():
    cell = small_cell("4k-clip", **SMALL_CLIP)
    out = registry.driver("clip")(cell, 2**31 + 5, 0.3, False, "cpu", cells.process_start())
    line = _line(cli.assemble(cell, out, False))
    assert line["correct"] and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"frames_per_s", "clip_p95_ms", "setup_s"}


def test_result_line_schema_traced():
    cell = small_cell("kadid-batch", **SMALL_SET)
    out = registry.driver("batch")(cell, 11, 0.3, True, "cpu", cells.process_start())
    line = _line(cli.assemble(cell, out, True))
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device on the CPU: the readers of device readings find nothing
    assert set(line["metrics"]) == {"launches_per_pair.batch"}


def test_trace_names_and_union():
    assert trace.kernel_symbol("(anonymous namespace)::reduce_kernel(float const*, int)") \
        == "reduce_kernel"
    assert trace.kernel_symbol("void fvvdp::sum_partials_kernel<64>(float const*)") \
        == "sum_partials_kernel"
    assert trace.union_ns([(0, 10), (5, 20), (30, 40)]) == (30, [(0, 20), (30, 40)])
    evs = [trace.Event(trace.WINDOW, 0, 100, False), trace.Event("k", 10, 30, True),
           trace.Event("k", 20, 50, True), trace.Event("cudaMemGetInfo", 60, 90, False)]
    s = trace.summarise(evs)
    assert s.busy_s == pytest.approx(40e-9) and s.window_s == pytest.approx(100e-9)
    assert s.idle_gaps[0][0] == "cudaMemGetInfo"


def test_end_to_end_reading_by_name():
    """A cell's metric takes the driver's reading of its own name, or of
    the name before its first dot."""
    got = {"pairs_per_s": 3.0, "setup_s": 1.0, "frames_per_s.host": 2.0}
    assert cli.end_to_end(got, "pairs_per_s.4proc") == 3.0
    assert cli.end_to_end(got, "frames_per_s.host") == 2.0
    with pytest.raises(KeyError):
        cli.end_to_end(got, "clip_p95_ms")


def test_workers_keep_to_the_cards_given(monkeypatch):
    """Worker r runs on the r-th card of the run's own CUDA_VISIBLE_DEVICES,
    never on card r of the machine."""
    assert cells.worker_cards(2, {"CUDA_VISIBLE_DEVICES": "5,6"}) == ["5", "6"]
    assert cells.worker_cards(2, {"CUDA_VISIBLE_DEVICES": "GPU-a, GPU-b,GPU-c"}) == ["GPU-a", "GPU-b"]
    assert cells.worker_cards(4, {}) == ["0", "1", "2", "3"]
    with pytest.raises(RuntimeError, match="need 2 cards"):
        cells.worker_cards(2, {"CUDA_VISIBLE_DEVICES": "5"})

    seen = []

    class Failing:
        returncode = 1

        def __init__(self, cmd, env, **k):
            seen.append(env["CUDA_VISIBLE_DEVICES"])

        def communicate(self):
            return "", None

        def poll(self):
            return 1

        def wait(self):
            return 1

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "5,6")
    monkeypatch.setattr(cells.subprocess, "Popen", Failing)
    cell = small_cell("kadid-batch-4proc", traffic={"processes": 2, "pairs": 100}, **SMALL_SET)
    with pytest.raises(RuntimeError, match="worker"):
        cells.run_processes(cell, 1, 1.0, False, cells.process_start(), ["worker"])
    assert seen == ["5", "6"]
