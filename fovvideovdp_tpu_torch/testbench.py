"""Comparison of intermediate tensors against golden dumps.

Counterpart of ``fovvideovdp_tpu/testbench.py`` (after the reference's
pyfvvdp/fvvdp_test.py:8-77): point it at a directory of ``.npz``, ``.npy``
or ``.mat`` dumps (from MATLAB, the PyTorch reference, the JAX package or
this one) and compare any intermediate with them, absolutely or
relatively, counting passes and failures.  With ``fvvdp(band_callback=...)``
it checks the bands of a run.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch


class FovVideoVDP_Testbench:
    """Compare intermediate tensors against golden dumps."""

    def __init__(self, golden_dir: str):
        self.golden_dir = golden_dir
        self.total_tested = 0
        self.total_passed = 0
        self.failures = []

    def _load(self, file: str, key: Optional[str]):
        for ext in (".npz", ".npy", ".mat"):
            path = os.path.join(self.golden_dir, file + ext)
            if not os.path.isfile(path):
                continue
            if ext == ".npz":
                with np.load(path) as z:
                    if key is not None and key not in z:
                        raise KeyError(
                            f"'{key}' not in {path} (has {list(z.files)}) — "
                            f"refusing to compare against an unrelated array")
                    return np.asarray(z[key] if key else z[z.files[0]])
            if ext == ".npy":
                return np.load(path)
            import scipy.io as sio
            m = sio.loadmat(path)
            if key is not None and key not in m:
                raise KeyError(f"'{key}' not in {path} (has "
                               f"{[k for k in m if not k.startswith('__')]})")
            data_keys = [kk for kk in m if not kk.startswith("__")]
            if key is None and not data_keys:
                raise RuntimeError(f"{path} holds no data variables")
            return np.asarray(m[key if key else data_keys[0]])
        return None

    def verify(self, tensor, file: str, key: Optional[str] = None,
               tolerance: float = 0.001, relative: bool = False,
               verbose: bool = False) -> bool:
        """Compare ``tensor`` (an array, or a tensor on any device) with the
        golden stored in ``file`` (``key`` optional): the largest absolute
        difference by default, the largest relative one with
        ``relative=True``, against ``tolerance``."""
        self.total_tested += 1
        golden = self._load(file, key)
        if golden is None:
            self.failures.append((file, "golden not found"))
            logging.warning(f"[testbench] golden '{file}' not found in "
                            f"{self.golden_dir}")
            return False

        if torch.is_tensor(tensor):
            tensor = tensor.detach().cpu().numpy()
        got = np.asarray(tensor, dtype=np.float64).squeeze()
        want = golden.astype(np.float64).squeeze()
        if got.shape != want.shape:
            self.failures.append((file, f"shape {got.shape} != {want.shape}"))
            return False

        diff = np.abs(got - want)
        if relative:
            denom = np.maximum(np.abs(want), 1e-12)
            err = (diff / denom).max()
        else:
            err = diff.max()
        ok = bool(err <= tolerance)
        if ok:
            self.total_passed += 1
        else:
            self.failures.append((file, f"max {'rel ' if relative else ''}err "
                                        f"{err:.3e} > {tolerance}"))
        if verbose or not ok:
            logging.info(f"[testbench] {file}: "
                         f"{'PASS' if ok else 'FAIL'} (err {err:.3e})")
        return ok

    def print_summary(self) -> bool:
        logging.info(f"[testbench] {self.total_passed}/{self.total_tested} "
                     f"comparisons passed")
        for file, why in self.failures:
            logging.info(f"  FAIL {file}: {why}")
        return self.total_passed == self.total_tested
