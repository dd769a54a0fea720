"""One batch scored by two processes through ``torch.distributed`` (gloo),
on the CPU: the counterpart of tests/test_multihost.py for
fovvideovdp_tpu_torch.  Each process (tests/_torch_multihost_worker.py)
scores its own pairs through ``predict_batch``; the results are gathered
over the group and each keeps its own rows, which must be the scores the
same pairs get in this process alone: equal to a one-process
``predict_batch`` and within 1e-5 JOD of per-pair ``predict`` (the bar of
tests/test_torch_batch.py: the same plain versions, summed a chunk at a
time).  A mismatched pair count raises the JAX package's error.

The workers get a timeout of their own and are killed on expiry, so a
stuck rendezvous cannot hold the suite."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from fovvideovdp_tpu_torch import fvvdp

WORKER = os.path.join(os.path.dirname(__file__), "_torch_multihost_worker.py")
TIMEOUT_S = 120
SELF_JOD = 1e-5

torch.set_num_threads(2)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_pair(tmp_path, *extra):
    """Both workers to their end (or killed at the timeout); their results."""
    port = _free_port()
    outs = [str(tmp_path / f"out{i}.json") for i in range(2)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-u", WORKER, str(i), str(port), outs[i], *extra],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for out in outs:
        with open(out) as f:
            results.append(json.load(f))
    return results


def _worker():
    sys.path.insert(0, os.path.dirname(WORKER))
    import _torch_multihost_worker
    return _torch_multihost_worker


def test_two_process_predict_batch(tmp_path):
    worker = _worker()
    fv = fvvdp(display_name="standard_fhd", device="cpu")
    for pid, res in enumerate(_run_pair(tmp_path)):
        assert res["n_processes"] == res["n_processes_video"] == 2
        tst, ref = worker.make_pairs(pid)
        tst_v, ref_v = worker.make_video_pairs(pid)
        assert len(res["jods"]) == len(res["jods_video"]) == 2
        q_pc = np.asarray(res["q_per_ch_video"], np.float32)
        assert q_pc.shape[2:] == (2, 3)      # this process's pairs only
        solo, _ = fv.predict_batch(tst, ref, dim_order="BHWC")
        solo_v, s_v = fv.predict_batch(tst_v, ref_v, dim_order="BFHWC", frames_per_second=30)
        assert np.array_equal(np.asarray(res["jods"], np.float32), solo)
        assert np.array_equal(np.asarray(res["jods_video"], np.float32), solo_v)
        assert np.array_equal(q_pc, s_v["Q_per_ch"])
        for k in range(2):
            q, _ = fv.predict(tst[k], ref[k], dim_order="HWC")
            assert abs(res["jods"][k] - q) <= SELF_JOD
            q, _ = fv.predict(tst_v[k], ref_v[k], dim_order="FHWC", frames_per_second=30)
            assert abs(res["jods_video"][k] - q) <= SELF_JOD


def test_two_process_pair_counts_must_match(tmp_path):
    """Process 0 passes 2 pairs, process 1 passes 3: both raise the JAX
    package's RuntimeError (fovvideovdp_tpu/fvvdp.py:1047-1057) before
    scoring."""
    for res in _run_pair(tmp_path, "mismatch"):
        assert res["error"] == ("predict_batch requires the same (padded) pair count on "
                                "every process; got [2, 3]")


def test_one_process_outside_a_group():
    from fovvideovdp_tpu_torch.parallel import (local_batch_to_global, local_row_positions,
                                                multihost, replicate_to_hosts)
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    assert local_batch_to_global(5) == slice(0, 5)
    assert np.array_equal(local_row_positions(5), np.arange(5))
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(replicate_to_hosts(x), x)
