"""The luminance stage of fovvideovdp_tpu_torch: integer-coded frames
through per-code tables (``ops/cuda/luminance.py``, ``csrc/luminance.cu``).

On the CPU: each table against the plain version on every code, for every
photometry; a plain-PyTorch emulation of the kernel (the launch plan's
strides, the tables' gather, the plain version's order of additions)
against the plain version on random frames in every layout a source hands
it; the launch plan; the route; the tables' cache key.  The ``gpu`` tests
hold the kernel to the plain version bit for bit on the card:
``python -m pytest --noconftest -m gpu tests/test_torch_luminance.py``.
"""
import types

import numpy as np
import pytest
import torch

from fovvideovdp_tpu_torch import display_model as dmod
from fovvideovdp_tpu_torch.ops.cuda import _lib
from fovvideovdp_tpu_torch.ops.cuda import luminance as lum
from fovvideovdp_tpu_torch.video_source import rgb_to_y

torch.set_num_threads(2)

RGB2Y = rgb_to_y("sRGB")

PHOTOMETRIES = {
    "srgb": lambda: dmod.fvvdp_display_photo_eotf(200, contrast=1000, EOTF="sRGB"),
    "gamma": lambda: dmod.fvvdp_display_photo_eotf(300, contrast=500, EOTF="gamma",
                                                   gamma=2.4, E_ambient=50),
    "pq": lambda: dmod.fvvdp_display_photo_eotf(1000, contrast=1e5, EOTF="PQ"),
    "linear": lambda: dmod.fvvdp_display_photo_eotf(200, contrast=1000, EOTF="linear"),
    "absolute": lambda: dmod.fvvdp_display_photo_absolute(L_max=200, L_min=0.2),
    "gog_srgb": lambda: dmod.fvvdp_display_photo_gog(200, contrast=1000, gamma=-1),
    "gog_2.2": lambda: dmod.fvvdp_display_photo_gog(200, contrast=1000, gamma=2.2),
}
CODES = {"uint8": torch.uint8, "int16": torch.int16}


@pytest.fixture
def one_thread():
    """One CPU thread: a parallel split of an elementwise pass leaves lanes
    at each split that the CPU's vectorised pow computes by its scalar
    loop, which may differ from its vector lanes in the last bits (up to 159
    ulp after the PQ EOTF's steep low end), so that a code's value would
    depend on where it lies in the tensor."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def emulate(blk, tabs):
    """The kernel in plain PyTorch: the launch plan's strides over blk's
    storage, each code's table entry, the plain version's order of sums."""
    plan = lum.launch_plan(blk, torch.empty(16, dtype=torch.float32)[4:])
    C = blk.shape[0]
    codes = torch.as_strided(blk, (C, plan.rows, plan.row_len),
                             (plan.channel_stride, plan.row_stride, plan.pixel_stride),
                             blk.storage_offset())
    idx = codes.to(torch.int64) & 0xFFFF
    out = tabs[0][idx[0]]
    for c in range(1, C):
        out = out + tabs[c][idx[c]]
    return out.reshape(blk.shape[1:])


def plain_whole_vectors(blk, dm):
    """The plain version on blk's codes, each channel laid out as one
    contiguous run padded to whole vectors of the CPU's widest unit, so that
    every code goes through the same lanes as in the tables' build."""
    C = blk.shape[0]
    flat = blk.reshape(C, -1)
    n = flat.shape[1]
    padded = torch.zeros((C, -(-n // 64) * 64), dtype=blk.dtype)
    padded[:, :n] = flat
    return lum.luminance_plain(padded, dm, RGB2Y)[:n].reshape(blk.shape[1:])


def code_ramp(dtype, C, layout):
    """Every code of the type in each of C channels, as a planar (C, 1, 1,
    n) block or an interleaved (n, C) run viewed channels first."""
    n = lum.N_CODES[dtype]
    ramp = torch.arange(n, dtype=torch.int32).to(dtype)
    if layout == "planar":
        return ramp.expand(C, n).contiguous().view(C, 1, 1, n)
    return ramp[:, None].expand(n, C).contiguous().view(1, 1, n, C).permute(3, 0, 1, 2)


@pytest.mark.parametrize("layout", ["planar", "bhwc"])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("code", sorted(CODES))
@pytest.mark.parametrize("photometry", sorted(PHOTOMETRIES))
def test_tables_match_plain_on_every_code(photometry, code, C, layout):
    """Bit for bit: the table of each code (256 for uint8, 65,536 for
    int16, read unsigned) is what the plain version computes for it, in a
    planar block and through the strides of an interleaved one."""
    dm, dtype = PHOTOMETRIES[photometry](), CODES[code]
    tabs = lum.build_tables(dm, RGB2Y, dtype, C, "cpu")
    assert tabs.shape == (C, lum.N_CODES[dtype]) and tabs.dtype == torch.float32
    blk = code_ramp(dtype, C, layout)
    want = lum.luminance_plain(blk, dm, RGB2Y)
    got = emulate(blk, tabs)
    assert got.shape == want.shape
    assert torch.equal(got, want)


def _bhwc_chunk(x, start, count):
    """PairBatch's view of pairs start..start+count-1 of a BHWC batch."""
    from fovvideovdp_tpu_torch.video_source import reshuffle_dims
    return reshuffle_dims(x.narrow(0, start, count), "BHWC", "BCFHW").transpose(0, 1)


def _codes(shape, dtype, seed, device="cpu"):
    hi = 255 if dtype == torch.uint8 else 65535
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, hi + 1, shape, generator=g, dtype=torch.int32).to(dtype).to(device)


# (C, n, ...) views as the sources hand them to the stage, made on a device
# from the code type, each with its expected plan: (rows, interleaved, vec)
LAYOUTS = {
    # the array source's block: frames 2..5 of a planar (C, F, H, W) clip
    "planar_block": (lambda d, dev: _codes((3, 8, 12, 20), d, 1, dev)[:, 2:6],
                     (1, False, True)),
    # its carried frames: index_select makes a new planar block
    "indexed_block": (lambda d, dev: _codes((3, 8, 12, 20), d, 2, dev).index_select(
        1, torch.tensor([3, 1, 1, 0], device=dev)), (1, False, True)),
    # PairBatch's chunk of a BHWC batch: interleaved, one run of pixels
    "bhwc_chunk": (lambda d, dev: _bhwc_chunk(_codes((7, 12, 20, 3), d, 3, dev), 2, 4),
                   (1, True, True)),
    # pixels that end off a group of 4: the ragged end
    "bhwc_ragged": (lambda d, dev: _bhwc_chunk(_codes((5, 9, 13, 3), d, 4, dev), 0, 3),
                    (1, True, True)),
    # a chunk that starts off a 4-byte boundary: scalar arm
    "bhwc_offset": (lambda d, dev: _bhwc_chunk(_codes((5, 9, 13, 3), d, 4, dev), 1, 3),
                    (1, True, False)),
    # frames_to_luminance: (n, C, H, W) frames viewed channels first
    "frames_first": (lambda d, dev: _codes((5, 3, 12, 20), d, 5, dev).transpose(0, 1),
                     (5, False, True)),
    # the same at an odd frame size: rows off a multiple of 4, scalar arm
    "frames_first_odd": (lambda d, dev: _codes((5, 3, 9, 13), d, 6, dev).transpose(0, 1),
                         (5, False, False)),
    # a BCFHW batch's pairs at a slice of frames: one row per pair
    "bcfhw_frames": (lambda d, dev: _codes((4, 3, 6, 12, 20), d, 7, dev)[1:3, :, 2:5]
                     .transpose(0, 1), (2, False, True)),
    # a grey clip's block
    "grey_block": (lambda d, dev: _codes((1, 8, 12, 20), d, 8, dev)[:, 3:7],
                   (1, False, True)),
    # a planar block one code off a 4-byte boundary: scalar arm
    "offset_block": (lambda d, dev: _codes((3 * 4 * 12 * 20 + 1,), d, 9, dev)[1:]
                     .view(3, 4, 12, 20), (1, False, False)),
}


@pytest.mark.parametrize("code", sorted(CODES))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_kernel_emulation_matches_plain_on_random_frames(one_thread, layout, code):
    """Bit for bit, for every photometry: the kernel's arithmetic, read
    through the launch plan's strides, on random codes in each layout the
    sources hand the stage, against the plain version of the same codes."""
    make, (rows, interleaved, vec) = LAYOUTS[layout]
    dtype = CODES[code]
    blk = make(dtype, "cpu")
    plan = lum.launch_plan(blk, torch.empty(16, dtype=torch.float32)[4:])
    assert (plan.rows, plan.interleaved, plan.vec) == (rows, interleaved, vec)
    for name, make_dm in PHOTOMETRIES.items():
        dm = make_dm()
        tabs = lum.build_tables(dm, RGB2Y, dtype, blk.shape[0], "cpu")
        got = emulate(blk, tabs)
        assert torch.equal(got, plain_whole_vectors(blk, dm)), name


def test_pixel_rows_merges_dims_and_gives_up_beyond_two():
    """Contiguous pixels are one row; the channel-interleaved pixels of a
    batch one row of stride 3; frames cut to a window of rows and columns
    three dims, which the wrapper copies first."""
    x = torch.zeros((3, 4, 6, 8), dtype=torch.uint8)
    assert lum.pixel_rows(x) == (1, 4 * 6 * 8, 0, 1)
    assert lum.pixel_rows(x[:, 1:3]) == (1, 2 * 6 * 8, 0, 1)
    assert lum.pixel_rows(x[:, :, None]) == (1, 4 * 6 * 8, 0, 1)
    assert lum.pixel_rows(x[:, :1, :1, :1]) == (1, 1, 0, 1)
    hwc = torch.zeros((4, 6, 8, 3), dtype=torch.uint8).permute(3, 0, 1, 2)
    assert lum.pixel_rows(hwc) == (1, 4 * 6 * 8, 0, 3)
    assert lum.pixel_rows(x.transpose(0, 1)) == (3, 6 * 8, 4 * 6 * 8, 1)
    assert lum.pixel_rows(x[:, :, :, 2:5]) == (4 * 6, 3, 8, 1)
    assert lum.pixel_rows(x[:, :, 1:5, 2:5]) is None


def test_launch_plan_grid_and_alignment():
    """Enough blocks for the pixels up to the fill, at least one; the
    vector arm refused for an output off a 16-byte boundary."""
    small = torch.zeros((3, 1, 4, 4), dtype=torch.uint8)
    out = torch.empty(32, dtype=torch.float32)
    assert lum.launch_plan(small, out[:16]).blocks == 1
    assert lum.launch_plan(small, out[:16]).vec
    assert not lum.launch_plan(small, out[1:17]).vec
    big = torch.zeros((1, 32, 2160, 3840), dtype=torch.uint8)
    assert lum.launch_plan(big, out[:16]).blocks == lum.FILL_BLOCKS


# ---------------------------------------------------------------------------
# Route
# ---------------------------------------------------------------------------

def _refuse(*a, **k):
    raise AssertionError("a table was built")


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.float16, torch.float32])
def test_cpu_frames_take_the_plain_version_without_a_table(monkeypatch, dtype):
    monkeypatch.setattr(lum, "build_tables", _refuse)
    monkeypatch.setattr(lum, "launch", _refuse)
    dm = PHOTOMETRIES["srgb"]()
    codes = _codes((3, 2, 5, 7), torch.uint8, 11)
    blk = {torch.uint8: codes, torch.int16: codes.to(torch.int16) * 200,
           torch.float16: (codes / 255).half(), torch.float32: codes / 255}[dtype]
    assert not lum.uses_kernel(blk)
    assert torch.equal(lum.luminance(blk, dm, RGB2Y), lum.luminance_plain(blk, dm, RGB2Y))


@pytest.mark.parametrize("dtype,kernel", [(torch.uint8, True), (torch.int16, True),
                                          (torch.float16, False), (torch.float32, False)])
def test_cuda_frames_route_by_their_type(monkeypatch, dtype, kernel):
    """Integer codes on a CUDA device go to the kernel with their tables;
    float frames on the card keep the plain version and build no table."""
    calls = []
    monkeypatch.setattr(lum, "tables", lambda dm, w, dt, C, dev: calls.append(
        ("tables", dt, C, dev)) or "tabs")
    monkeypatch.setattr(lum, "launch", lambda blk, tabs: calls.append(("launch", tabs)) or "L")
    monkeypatch.setattr(lum, "luminance_plain", lambda blk, dm, w: calls.append("plain") or "P")
    dev = torch.device("cuda", 0)
    blk = types.SimpleNamespace(device=dev, dtype=dtype, shape=(3, 2, 5, 7))
    assert lum.uses_kernel(blk) == kernel
    got = lum.luminance(blk, PHOTOMETRIES["srgb"](), RGB2Y)
    if kernel:
        assert got == "L" and calls == [("tables", dtype, 3, dev), ("launch", "tabs")]
    else:
        assert got == "P" and calls == ["plain"]


def test_kernel_route_refuses_other_channel_counts(monkeypatch):
    monkeypatch.setattr(lum, "tables", _refuse)
    blk = types.SimpleNamespace(device=torch.device("cuda", 0), dtype=torch.uint8,
                                shape=(2, 1, 4, 4))
    with pytest.raises(ValueError, match="1 or 3 colour channels"):
        lum.luminance(blk, PHOTOMETRIES["srgb"](), RGB2Y)


@pytest.mark.parametrize("entry", ["array_block", "array_indexed", "frames_to_luminance",
                                   "pair_batch"])
def test_sources_convert_through_the_stage(monkeypatch, entry):
    """Every caller of the stage hands it the raw codes in their stored
    type, channels first."""
    import fovvideovdp_tpu_torch as fvt
    from fovvideovdp_tpu_torch.video_source import PairBatch
    seen = []
    real = lum.luminance
    monkeypatch.setattr(lum, "luminance", lambda blk, dm, w: seen.append(
        (blk.dtype, tuple(blk.shape))) or real(blk, dm, w))
    clip = _codes((12, 20, 3, 6), torch.uint8, 12).numpy()
    dm = PHOTOMETRIES["srgb"]()
    if entry.startswith("array"):
        src = fvt.fvvdp_video_source_array(clip, clip, 30, dim_order="HWCF",
                                           display_photometry=dm, device="cpu")
        if entry == "array_block":
            src.get_luminance_block(1, 4)
        else:
            src.get_indexed_luminance_block(np.array([2, 0]))
    elif entry == "frames_to_luminance":
        src = fvt.fvvdp_video_source_array(clip, clip, 30, dim_order="HWCF",
                                           display_photometry=dm, device="cpu")
        src.frames_to_luminance(torch.from_numpy(clip).permute(3, 2, 0, 1)[:4])
    else:
        batch = torch.from_numpy(clip).permute(3, 0, 1, 2)     # (6, 12, 20, 3) BHWC
        PairBatch(batch, batch, "BHWC", 0, dm, RGB2Y, "cpu").luminance(1, 3)
    n = {"array_block": 4, "array_indexed": 2, "frames_to_luminance": 4, "pair_batch": 3}[entry]
    shape = (3, n, 1, 12, 20) if entry == "pair_batch" else (3, n, 12, 20)
    assert seen and all(s == (torch.uint8, shape) for s in seen)


# ---------------------------------------------------------------------------
# The tables' cache key
# ---------------------------------------------------------------------------

def _key(dm, rgb2y=RGB2Y, dtype=torch.uint8, C=3, device="cuda:0"):
    return lum.table_key(dm, rgb2y, dtype, C, device)


@pytest.mark.parametrize("change", [dict(Y_peak=201), dict(contrast=999), dict(EOTF="gamma"),
                                    dict(gamma=2.4), dict(E_ambient=1), dict(k_refl=0.01)])
def test_table_key_separates_photometries_that_differ_in_one_parameter(change):
    base = dict(Y_peak=200, contrast=1000, EOTF="sRGB", gamma=2.2, E_ambient=0, k_refl=0.005)
    a = dmod.fvvdp_display_photo_eotf(**base)
    assert _key(a) == _key(dmod.fvvdp_display_photo_eotf(**base))
    assert _key(a) != _key(dmod.fvvdp_display_photo_eotf(**dict(base, **change)))


def test_table_key_separates_class_weights_type_and_device():
    a = dmod.fvvdp_display_photo_gog(200, contrast=1000, gamma=2.2)
    b = dmod.fvvdp_display_photo_eotf(200, contrast=1000, EOTF="gamma", gamma=2.2)
    assert _key(a) != _key(b)
    assert _key(a) != _key(a, rgb2y=(0.3, 0.6, 0.1))
    assert _key(a, C=1) == _key(a, rgb2y=(0.3, 0.6, 0.1), C=1)
    assert _key(a) != _key(a, dtype=torch.int16)
    assert _key(a) != _key(a, device="cuda:1")
    assert _key(a, device="cuda:0") == _key(a, device=torch.device("cuda", 0))


# ---------------------------------------------------------------------------
# On the card: the kernel against the plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("code", sorted(CODES))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_kernel_matches_plain_on_the_card(cuda, layout, code):
    """Bit for bit on both arms, every photometry, each layout in place;
    one launch per conversion."""
    make, (rows, interleaved, vec) = LAYOUTS[layout]
    blk = make(CODES[code], cuda)
    out = torch.empty(blk.shape[1:], dtype=torch.float32, device=cuda)
    assert lum.launch_plan(blk, out).vec == vec
    for name, make_dm in PHOTOMETRIES.items():
        dm = make_dm()
        _lib.reset_launch_counts()
        got = lum.luminance(blk, dm, RGB2Y)
        assert _lib.launch_counts()["luminance"] == 1
        want = lum.luminance_plain(blk, dm, RGB2Y)
        assert torch.equal(got, want), name


@pytest.mark.gpu
@pytest.mark.parametrize("bad", ["vec_offset", "vec_interleaved", "rows", "channels", "blocks"])
def test_luminance_entry_point_refuses_a_plan_that_contradicts_it(cuda, bad):
    x = torch.zeros((3, 4, 8, 8), dtype=torch.uint8, device=cuda)
    out = torch.empty((4, 8, 8), device=cuda)
    tabs = torch.zeros((3, 256), device=cuda)
    plan = lum.launch_plan(x, out)
    args = dict(x=x.data_ptr(), n=out.numel(), plan=list(plan[:5]), C=3, interleaved=0,
                vec=1, blocks=plan.blocks)
    if bad == "vec_offset":
        args["x"] += 1
    elif bad == "vec_interleaved":
        args["interleaved"] = 1
    elif bad == "rows":
        args["plan"][0] = 2
    elif bad == "channels":
        args["C"] = 2
    else:
        args["blocks"] = 0
    rc = _lib.kernel_fn("luminance")(args["x"], tabs.data_ptr(), out.data_ptr(), args["n"],
                                     *args["plan"], args["C"], 1, args["interleaved"],
                                     args["vec"], args["blocks"], _lib.stream_ptr(x))
    assert rc != 0
