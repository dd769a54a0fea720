"""Scoring worker of the port's kill-and-resume test (run as a subprocess).

Usage: python _torch_checkpoint_worker.py <ckpt_path> [kill_after_fetches]

Scores a seeded 12-frame clip with fovvideovdp_tpu_torch on the CPU, with
``checkpoint_path`` set and a checkpoint after every block.  With
``kill_after_fetches`` > 0 the source SIGKILLs its own process after serving
that many luminance blocks: a death without atexit or unwinding, the case
checkpoint and resume exist for.  Otherwise it scores to the end and prints
the JOD, the number of block fetches and the blocks it read (a resumed run
reads fewer: the scored prefix is skipped).  Imports no JAX."""
import os
import signal
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from fovvideovdp_tpu_torch import fvvdp  # noqa: E402
from fovvideovdp_tpu_torch.video_source import fvvdp_video_source_array  # noqa: E402

CKPT = sys.argv[1]
KILL_AFTER = int(sys.argv[2]) if len(sys.argv) > 2 else 0


class SelfKillingSource(fvvdp_video_source_array):
    fetches = 0
    starts = []

    def get_luminance_block(self, pos, n):
        type(self).fetches += 1
        if KILL_AFTER and type(self).fetches > KILL_AFTER:
            os.kill(os.getpid(), signal.SIGKILL)     # no cleanup
        if n > 1:
            type(self).starts.append(int(pos))
        return super().get_luminance_block(pos, n)


def main():
    torch.set_num_threads(1)
    rng = np.random.RandomState(17)
    F, H, W = 12, 32, 48
    ref = (rng.rand(F, H, W, 3) * 255).astype(np.uint8)
    tst = np.clip(ref.astype(np.int16) + rng.randint(-20, 20, ref.shape),
                  0, 255).astype(np.uint8)
    fv = fvvdp(display_name="standard_fhd", block_frames=4, device="cpu")
    vs = SelfKillingSource(tst, ref, 30, dim_order="FHWC",
                           display_photometry=fv.display_photometry, device="cpu")
    Q, _ = fv.predict_video_source(vs, checkpoint_path=CKPT, checkpoint_every=1)
    print(f"FINAL_Q={Q!r}")
    print(f"FETCHES={SelfKillingSource.fetches}")
    print(f"STARTS={','.join(map(str, SelfKillingSource.starts))}")
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "fovvideovdp_tpu")]
    print(f"FORBIDDEN={len(bad)}")


if __name__ == "__main__":
    main()
