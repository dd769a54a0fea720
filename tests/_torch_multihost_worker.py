"""One process of the port's two-process batch test (run as a subprocess).

Usage: python _torch_multihost_worker.py <process_id> <port> <out.json> [mismatch]

Joins a 2-process gloo group on localhost (``parallel.init_multihost``) and
scores ITS OWN seeded pairs through ``fvvdp.predict_batch`` on the CPU: two
RGB images and two 3-frame clips.  The results of both processes are
gathered over the group and each keeps its own rows; it writes them to
<out.json>.  With ``mismatch``, process 1 passes one pair more than process
0, and the error ``predict_batch`` raises is written instead.  Imports no
JAX (the counterpart of tests/_multihost_worker.py)."""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)


def make_pairs(pid, n=2):
    rng = np.random.RandomState(100 + pid)
    ref = (rng.rand(n, 32, 48, 3) * 255).astype(np.uint8)
    tst = np.clip(ref.astype(np.int16) + rng.randint(-30, 30, ref.shape),
                  0, 255).astype(np.uint8)
    return tst, ref


def make_video_pairs(pid):
    rng = np.random.RandomState(200 + pid)
    ref = (rng.rand(2, 3, 32, 48, 1) * 255).astype(np.uint8)
    tst = np.clip(ref.astype(np.int16) + rng.randint(-30, 30, ref.shape),
                  0, 255).astype(np.uint8)
    return tst, ref


def main():
    pid, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    mismatch = len(sys.argv) > 4 and sys.argv[4] == "mismatch"
    import torch.distributed as dist
    from fovvideovdp_tpu_torch import fvvdp
    from fovvideovdp_tpu_torch.parallel import init_multihost
    init_multihost(f"localhost:{port}", num_processes=2, process_id=pid)
    try:
        fv = fvvdp(display_name="standard_fhd", device="cpu")
        if mismatch:
            try:
                fv.predict_batch(*make_pairs(pid, 2 + pid), dim_order="BHWC")
                res = {"error": None}
            except RuntimeError as e:
                res = {"error": str(e)}
        else:
            jods, stats = fv.predict_batch(*make_pairs(pid), dim_order="BHWC")
            jods_v, stats_v = fv.predict_batch(*make_video_pairs(pid), dim_order="BFHWC",
                                               frames_per_second=30)
            res = {"jods": jods.tolist(), "jods_video": jods_v.tolist(),
                   "q_per_ch_video": stats_v["Q_per_ch"].tolist(),
                   "n_processes": stats["n_processes"],
                   "n_processes_video": stats_v["n_processes"]}
        with open(out, "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
