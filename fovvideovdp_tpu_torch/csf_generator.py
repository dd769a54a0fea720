"""Analytic spatio-temporal foveated CSF — the LUT generator.

This package's copy of ``fovvideovdp_tpu/csf_generator.py`` (numpy only, so
both packages generate identical LUTs).  It ports the *science* of the
MATLAB-only CSF generation chain so that new LUT keys (omega, sigma, k_cm)
can be produced directly from Python (the generator of the reference lives
only in matlab/utils/CSF_st_fov.m).

Model chain (with reference citations):
* cortical magnification, Dougherty et al. 2003:  M(e) = 29.2/(e+3.67) mm/deg
  (matlab/utils/cortical_magnification_dougherty.m:15-18)
* spatio-velocity CSF, Laird/Daly 2006 fit
  (matlab/utils/csf_spatiovel_daly.m:17-36); temporal modulation ratio
  S(rho, omega)/S(rho, 0) (matlab/utils/CSF_st_fov.m:162)
* spatio-chromatic cone-contrast CSF: log-parabola x Rovamo-area model with
  the 16/09/2020 calibration (matlab/utils/SCCSF_ConeContrastMat.m:231-263,
  matlab/utils/SCCSF.m:183-208)
* CIE2006 LMS from XYZ for an LED LCD (matlab/utils/xyz2lms2006.m:14-17)

Everything is plain numpy (generation is offline); the produced LUT matches
the shipped calibration files to float32 precision.
"""
from __future__ import annotations

import numpy as np

# Grid constants (matlab/utils/CSF_st_fov.m:4-9)
Y_MIN, Y_MAX = 0.001, 10000.0
RHO_MIN, RHO_MAX = 2.0 ** -4, 64.0
ECC_MAX = 120.0
LUT_N = 32

# CIE 1931 XYZ of the D65 white point (Y normalised to 1).
WHITEPOINT_D65 = np.array([0.9504, 1.0000, 1.0888])

# XYZ -> CIE2006 LMS for LED-LCD spectra (matlab/utils/xyz2lms2006.m:14-17)
M_XYZ_LMS2006 = np.array([
    [0.187596268556126, 0.585168649077728, -0.026384263306304],
    [-0.133397430663221, 0.405505777260049, 0.034502127690364],
    [0.000244379021663, -0.000542995890619, 0.019406849066323]])


def xyz2lms2006(xyz: np.ndarray) -> np.ndarray:
    return np.asarray(xyz) @ M_XYZ_LMS2006.T


def cortical_magnification_dougherty(e):
    """Cortical magnification in mm/deg."""
    A = 29.2   # mm
    e_2 = 3.67  # deg
    return A / (np.asarray(e, dtype=np.float64) + e_2)


def csf_spatiovel_daly(rho, vel):
    """Laird/Daly spatio-velocity CSF (2006 calibrated fit).

    rho in cpd, vel in deg/s; vel is clamped to >= 0.1 deg/s (fixational eye
    motion) to keep the model defined at vel = 0."""
    min_vel = 0.1
    s1, s2, p1 = 6.1, 7.3, 45.9
    c0, c1, c2 = 0.6329, 0.8404, 0.7986

    vel_c = np.maximum(vel, min_vel)
    k = s1 + s2 * np.abs(np.log10(c2 * vel_c / 3.0)) ** 3
    rho_max = p1 / (c2 * vel_c + 2.0)
    return (k * (c0 * c1 * c2) * vel_c * (c1 * 2 * np.pi * rho) ** 2
            * np.exp(-(c1 * 4 * np.pi * rho) / rho_max))


def csf_spatiotemp_daly(rho, omega):
    """Spatio-temporal CSF via retinal velocity vel = omega/rho."""
    return csf_spatiovel_daly(rho, omega / rho)


# ---------------------------------------------------------------------------
# Spatio-chromatic cone-contrast CSF (SCCSF_ConeContrastMat calibration)
# ---------------------------------------------------------------------------

# Per-mechanism parameters, fitted 16/09/2020
# (matlab/utils/SCCSF_ConeContrastMat.m:236-254)
_CM_PARS = [
    dict(S_max=[356404, 6.2726, 0.320031, 895943, 7.77919e-05],
         f_max=[2.3021, 3317.45, 0.186215], bw=1.07516, gamma=1.1107,
         Ac_prime=52.9768),
    dict(S_max=[423.978, 15.4032, 0.50343],
         f_max=[0.122699], bw=2.70669, gamma=1.72903, Ac_prime=1.38437),
    dict(S_max=[11811.9, 196.342, 0.339396],
         f_max=[7.1099e-08], bw=5.3416, gamma=1.47263, Ac_prime=0.282573),
]
_COLMAT = [0.00130319, 0.256197, 0.933541, 1.1504, 6.42477e-07, 0.00373304]

# Colour-direction vectors in DKL-aligned LMS space (matlab/utils/SCCSF.m:79-88)
_COLDIR_DELTA = {
    1: np.array([0.698, 0.302, 0.019613]),   # achromatic
    2: np.array([0.302, -0.302, 0.0]),       # red-green
    3: np.array([0.0, 0.0, 0.019613]),       # violet-yellow
}

_BETA = 2.0


def lms2acc_matrix() -> np.ndarray:
    """Colour-mechanism matrix.  Free entries fill the non-fixed positions of
    the mechanism matrix in MATLAB column-major order
    (SCCSF_ConeContrastMat.m:32-40), then signs are applied."""
    M = np.ones((3, 3))
    # column-major order of the entries where Mones == 0:
    # (3,1), (1,2), (2,2), (3,2), (1,3), (2,3)  [1-indexed]
    free = [(2, 0), (0, 1), (1, 1), (2, 1), (0, 2), (1, 2)]
    for (r, c), v in zip(free, _COLMAT):
        M[r, c] = v
    sign = np.array([[1, 1, 1], [1, -1, 1], [-1, -1, 1]], dtype=np.float64)
    return M * sign


def get_lum_dep(pars, L):
    """Family of luminance-dependency functions (matlab/utils/SCCSF.m:183-208)."""
    L = np.asarray(L, dtype=np.float64)
    pars = list(pars)
    if len(pars) == 1:
        return np.full_like(L, pars[0])
    if len(pars) == 2:
        return 10.0 ** (pars[0] * np.log10(L) + pars[1])
    if len(pars) == 3:
        return pars[0] * (1 + pars[1] / L) ** (-pars[2])
    if len(pars) == 5:
        return (pars[0] * (1 + pars[1] / L) ** (-pars[2])
                * (1 - (1 + pars[3] / L) ** (-pars[4])))
    raise ValueError("Unsupported luminance-dependency parameter count")


def _csf_freq_size(freq, area, color_dir, S_max, f_max, bw, gamma, Ac_prime):
    """Log-parabola x Rovamo-area model (SCCSF_ConeContrastMat.m:183-222)."""
    S_peak = S_max / 10.0 ** ((np.log10(freq) - np.log10(f_max)) ** 2 / (0.5 * 2.0 ** bw))
    if color_dir > 1:  # low-pass for chromatic mechanisms
        S_peak = np.where(freq < f_max, S_max, S_peak)
    f0 = 0.65
    k = Ac_prime + area * f0
    return S_peak * np.sqrt(area ** gamma * freq ** 2 / (k + area ** gamma * freq ** 2))


def _csf_freq_size_lum(freq, area, color_dir, lum):
    p = _CM_PARS[color_dir - 1]
    return _csf_freq_size(
        freq, area, color_dir,
        S_max=get_lum_dep(p["S_max"], lum),
        f_max=get_lum_dep(p["f_max"], lum),
        bw=p["bw"], gamma=p["gamma"], Ac_prime=p["Ac_prime"])


def sccsf_pdet(freq, LMS_mean, LMS_delta, area):
    """Probability of detecting a Gabor patch of a given chromatic direction
    and amplitude (SCCSF_ConeContrastMat.m:42-77).

    Returns (P, C): detection probability and normalised detection contrast
    (C = 1 at threshold)."""
    LMS_mean = np.atleast_2d(np.asarray(LMS_mean, dtype=np.float64))
    LMS_delta = np.atleast_2d(np.asarray(LMS_delta, dtype=np.float64))

    M = lms2acc_matrix()
    lum = LMS_mean[:, 0] + LMS_mean[:, 1]

    CC_LMS = LMS_delta / LMS_mean
    CC_ACC = CC_LMS @ M.T

    C_n = np.zeros_like(CC_ACC)
    for cd in (1, 2, 3):
        C_n[:, cd - 1] = np.abs(CC_ACC[:, cd - 1]) * _csf_freq_size_lum(freq, area, cd, lum)
    C = np.sum(C_n ** _BETA, axis=1) ** (1.0 / _BETA)
    P = 1.0 - np.exp(np.log(0.5) * C)
    return P, C


def sccsf_sensitivity(freq, LMS_mean, LMS_delta, area):
    """Sensitivity + threshold colour offset for a chromatic direction
    (SCCSF_ConeContrastMat.m:79-108).

    Returns (S, LMS_delta_thr, P, C)."""
    LMS_mean = np.atleast_2d(np.asarray(LMS_mean, dtype=np.float64))
    LMS_delta = np.atleast_2d(np.asarray(LMS_delta, dtype=np.float64))
    P, C = sccsf_pdet(freq, LMS_mean, LMS_delta, area)
    LMS_delta_thr = LMS_delta / C[:, None]
    S = 1.0 / (np.sqrt(np.sum((LMS_delta_thr / LMS_mean) ** 2, axis=1)) / np.sqrt(3.0))
    return S, LMS_delta_thr, P, C


def sccsf_sensitivity_coldir(freq, LMS_mean, color_direction, area):
    """Cone-contrast sensitivity along a DKL colour direction
    (SCCSF.m:72-92): 1 = achromatic, 2 = red-green, 3 = violet-yellow."""
    LMS_delta = _COLDIR_DELTA[color_direction]
    S, _, _, _ = sccsf_sensitivity(freq, LMS_mean, LMS_delta[None, :], area)
    return S


# ---------------------------------------------------------------------------
# Full spatio-temporal foveated sensitivity + LUT builder
# ---------------------------------------------------------------------------

def sensitivity(rho, omega, L_bkg, ecc, sigma=1.0, k_cm=1.0):
    """S(rho, omega, L_bkg, ecc) — matlab/utils/CSF_st_fov.m:137-174.

    sigma < 0 selects the fixed-cycles mode (sigma encodes a wavelength:
    stimulus radius = -sigma/rho)."""
    rho = np.asarray(rho, dtype=np.float64).ravel()
    L_bkg = np.asarray(L_bkg, dtype=np.float64).ravel()
    ecc = np.asarray(ecc, dtype=np.float64).ravel()

    sig = -sigma / rho if sigma < 0 else np.full_like(rho, sigma)

    M_rel = (cortical_magnification_dougherty(ecc)
             / cortical_magnification_dougherty(0.0)) ** k_cm
    A_cm = np.pi * (sig * M_rel) ** 2   # stimulus area under cortical magnification
    rho_cm = rho / M_rel                # frequency under cortical magnification

    S_st = csf_spatiotemp_daly(rho_cm, omega) / (csf_spatiotemp_daly(rho_cm, 0.0) + 1e-5)

    LMS_d65 = xyz2lms2006(WHITEPOINT_D65)
    S_sp = sccsf_sensitivity_coldir(rho_cm, L_bkg[:, None] * LMS_d65[None, :], 1, A_cm)

    return S_sp * S_st


def precompute_lut(omega: float, sigma: float, k_cm: float, n: int = LUT_N) -> dict:
    """Build a sensitivity LUT in the shipped cache format
    (matlab/utils/CSF_st_fov.m:107-130): S_log indexed [Y, rho, ecc]."""
    Y = np.logspace(np.log10(Y_MIN), np.log10(Y_MAX), n).astype(np.float32)
    rho = np.logspace(np.log10(RHO_MIN), np.log10(RHO_MAX), n).astype(np.float32)
    ecc = (np.linspace(0.0, np.sqrt(ECC_MAX), n) ** 2).astype(np.float32)

    Y_gd, rho_gd, ecc_gd = np.meshgrid(Y, rho, ecc, indexing="ij")
    S = np.maximum(sensitivity(rho_gd, omega, Y_gd, ecc_gd, sigma, k_cm), 1e-4)

    return dict(
        Y=Y, rho=rho, ecc=ecc,
        Y_log=np.log2(Y), rho_log=np.log2(rho), ecc_sqrt=np.sqrt(ecc),
        S_log=np.log2(S).reshape(n, n, n).astype(np.float32))
