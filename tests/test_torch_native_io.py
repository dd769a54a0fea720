"""fovvideovdp_tpu_torch's native host-I/O reader (``native/``): built with
g++ at first use, it reads what the JAX package's reader reads, writes into
a caller-given buffer, and raises when it cannot be built.  The cases of
``tests/test_native_io.py``, with the JAX package's reader as the other
side where both read the same file.
"""
import os
import stat
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from fovvideovdp_tpu import native as jax_native
from fovvideovdp_tpu_torch import native

H, W, F = 32, 48, 6


@pytest.fixture
def yuv_file(tmp_path):
    rng = np.random.RandomState(0)
    fname = tmp_path / f"clip_{W}x{H}_10b_420_709_30fps.yuv"
    frames = []
    with open(fname, "wb") as f:
        for _ in range(F):
            y = rng.randint(0, 1023, (H, W), dtype=np.uint16)
            u = rng.randint(0, 1023, (H // 2, W // 2), dtype=np.uint16)
            v = rng.randint(0, 1023, (H // 2, W // 2), dtype=np.uint16)
            for p in (y, u, v):
                f.write(p.tobytes())
            frames.append(np.concatenate([y.ravel(), u.ravel(), v.ravel()]))
    return str(fname), np.stack(frames)


def test_read_block_and_indices(yuv_file):
    path, frames = yuv_file
    r = native.NativeYuvReader(path, W, H, 10, "420")
    assert r.frame_count == F and r.frame_bytes == frames[0].nbytes
    np.testing.assert_array_equal(r.read_block(1, 3), frames[1:4])
    # random access (circular-padding pattern), then sequential again
    np.testing.assert_array_equal(r.read_indices([5, 0, 3]), frames[[5, 0, 3]])
    np.testing.assert_array_equal(r.read_block(0, 6), frames)
    r.close()


def test_reads_what_the_jax_package_reads(yuv_file):
    path, _ = yuv_file
    if jax_native.load() is None:
        pytest.skip("the JAX package's reader has no C++ toolchain")
    mine = native.NativeYuvReader(path, W, H, 10, "420")
    theirs = jax_native.NativeYuvReader(path, W, H, 10, "420")
    np.testing.assert_array_equal(mine.read_block(0, F), theirs.read_block(0, F))
    np.testing.assert_array_equal(mine.read_indices([4, 1, 1]), theirs.read_indices([4, 1, 1]))
    mine.close()
    theirs.close()


@pytest.mark.parametrize("kind", ["numpy", "tensor", "byte-slice"])
def test_read_block_into_a_caller_buffer(yuv_file, kind):
    path, frames = yuv_file
    r = native.NativeYuvReader(path, W, H, 10, "420")
    if kind == "numpy":
        out = np.zeros((3, frames.shape[1]), dtype=np.uint16)
        assert r.read_block(2, 3, out=out) is out
        np.testing.assert_array_equal(out, frames[2:5])
    else:
        buf = torch.zeros(4 * r.frame_bytes + 6, dtype=torch.uint8)
        out = buf if kind == "tensor" else buf[6:]
        r.read_indices([3, 1, 4, 1], out=out)
        got = out[:4 * r.frame_bytes].numpy().view(np.uint16).reshape(4, -1)
        np.testing.assert_array_equal(got, frames[[3, 1, 4, 1]])
    r.close()


@pytest.mark.parametrize("out", [
    lambda: np.zeros(10, dtype=np.uint8),
    lambda: np.zeros((3, 2 * H * W * 3), dtype=np.uint8)[:, ::2],
    lambda: torch.zeros((2, 6000), dtype=torch.int16).t(),
    lambda: [0] * 10,
], ids=["too-small", "strided-array", "strided-tensor", "list"])
def test_caller_buffer_is_checked(yuv_file, out):
    path, _ = yuv_file
    r = native.NativeYuvReader(path, W, H, 10, "420")
    with pytest.raises((ValueError, TypeError)):
        r.read_block(0, 2, out=out())
    r.close()


def test_out_of_range(yuv_file):
    path, _ = yuv_file
    r = native.NativeYuvReader(path, W, H, 10, "420")
    with pytest.raises(RuntimeError):
        r.read_block(4, 5)  # past EOF
    with pytest.raises(RuntimeError):
        r.read_indices([0, F])
    r.close()


def _spawn_byte_producer(py_body):
    return subprocess.Popen([sys.executable, "-c", py_body], stdout=subprocess.PIPE)


def _end(p, r):
    p.kill()
    r.close()
    p.stdout.close()
    p.wait()


@pytest.mark.parametrize("into", [False, True], ids=["array", "caller-buffer"])
def test_pipe_reader_streams_and_eof(into):
    """Frames stream through the ring in order; a partial trailing frame is
    dropped at EOF; reads past EOF return nothing."""
    fb, n = 1000, 25
    p = _spawn_byte_producer(
        "import sys\n"
        f"data = bytes((i * 7 + j) % 256 for i in range({n}) for j in range({fb}))\n"
        "sys.stdout.buffer.write(data + b'\\x42' * 17)\n")
    r = native.NativePipeReader(p.stdout.fileno(), fb, ring_frames=4)
    expect = np.array([[(i * 7 + j) % 256 for j in range(fb)] for i in range(n)],
                      dtype=np.uint8)
    if into:
        buf = torch.zeros((n + 3, fb), dtype=torch.uint8)
        counts = [r.read_block(7, out=buf[k * 7:]) for k in range(4)]
        assert counts == [7, 7, 7, 4]
        np.testing.assert_array_equal(buf[:n].numpy(), expect)
        assert r.read_block(3, out=buf) == 0
    else:
        got = [r.read_block(7) for _ in range(5)]
        np.testing.assert_array_equal(np.concatenate(got[:4]), expect)
        assert got[4].shape[0] == 0  # EOF; the 17 trailing bytes are dropped
    _end(p, r)


def test_pipe_reader_prefetches_ahead(tmp_path):
    """The background drain lets a producer finish writing more than the
    kernel pipe holds while the consumer reads nothing."""
    fb = 1 << 20  # 1 MB frames >> 64 KB kernel pipe
    done = tmp_path / "done"
    p = _spawn_byte_producer(
        "import sys\n"
        f"sys.stdout.buffer.write(b'\\xab' * ({fb} * 3))\n"
        "sys.stdout.buffer.flush()\n"
        f"open({str(done)!r}, 'w').close()\n")
    r = native.NativePipeReader(p.stdout.fileno(), fb, ring_frames=4)
    deadline = time.time() + 30
    while not done.exists() and time.time() < deadline:
        time.sleep(0.02)  # consumer idle: only the ring can absorb 3 MB
    assert done.exists(), "producer stalled: pipe was not drained ahead"
    blk = r.read_block(3)
    assert blk.shape == (3, fb) and (blk == 0xAB).all()
    _end(p, r)


def _stub_ffmpeg(tmp_path, monkeypatch, raw, probe):
    import json
    bindir = tmp_path / "bin"
    bindir.mkdir()
    vid = tmp_path / "v.mp4"
    vid.write_bytes(raw.tobytes())
    (tmp_path / "v.mp4.probe.json").write_text(json.dumps(probe))
    for name, body in (
            ("ffprobe", "import sys\nprint(open(sys.argv[-1] + '.probe.json').read())\n"),
            ("ffmpeg", "import sys\n"
                       "path = sys.argv[sys.argv.index('-i') + 1]\n"
                       "sys.stdout.buffer.write(open(path, 'rb').read())\n")):
        exe = bindir / name
        exe.write_text(f"#!{sys.executable}\n{body}")
        os.chmod(exe, os.stat(exe).st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    return str(vid)


@pytest.mark.parametrize("reader", ["native", "python"])
def test_video_reader_pipe(tmp_path, monkeypatch, reader):
    """video_reader drains the pipe through the native reader by default,
    with blocking reads only when asked; both give the bytes the JAX
    package's reader gives."""
    from fovvideovdp_tpu.video_source_file import video_reader as jax_reader
    from fovvideovdp_tpu_torch.video_source_file import video_reader
    h, w, n = 24, 32, 4
    raw = (np.arange(h * w * 3 * n, dtype=np.int64).reshape(n, -1) % 251).astype(np.uint8)
    vid = _stub_ffmpeg(tmp_path, monkeypatch, raw, {"streams": [
        {"codec_type": "video", "width": w, "height": h, "pix_fmt": "rgb24",
         "nb_frames": str(n), "r_frame_rate": "30/1"}]})
    vr = video_reader(vid, reader=reader)
    np.testing.assert_array_equal(vr.get_frames_block(2), raw[:2])
    buf = torch.zeros((5, h * w * 3), dtype=torch.uint8)
    assert vr.get_frames_block(5, out=buf) == 2      # the frame count caps the read
    np.testing.assert_array_equal(buf[:2].numpy(), raw[2:])
    assert vr.get_frames_block(1) is None and vr.get_frames_block(1, out=buf) == 0
    assert bool(vr._pipe) == (reader == "native")
    vr.close()
    jr = jax_reader(vid)
    np.testing.assert_array_equal(jr.get_frames_block(n), raw)
    jr.close()


def test_video_reader_rejects_unknown_reader(tmp_path):
    from fovvideovdp_tpu_torch.video_source_file import video_reader
    with pytest.raises(ValueError, match="reader"):
        video_reader(str(tmp_path / "none.mp4"), reader="memmap")


@pytest.mark.parametrize("reader", ["native", "python"])
def test_yuvreader_readers_agree(yuv_file, reader):
    path, frames = yuv_file
    from fovvideovdp_tpu_torch.video_source_yuv import YUVReader
    r = YUVReader(path, reader=reader)
    assert (r.native is not None) == (reader == "native")
    np.testing.assert_array_equal(r.read_raw_block(0, 2), frames[:2])
    np.testing.assert_array_equal(r.read_raw_indices([5, 2]), frames[[5, 2]])
    buf = torch.zeros(2 * r.frame_bytes, dtype=torch.uint8)
    r.read_raw_indices([1, 4], out=buf)
    np.testing.assert_array_equal(buf.numpy().view(np.uint16).reshape(2, -1), frames[[1, 4]])
    with pytest.raises(RuntimeError):
        r.read_raw_block(F - 1, 2)
    r.close()


def test_native_reader_prefetch_race(tmp_path):
    """Every delivered frame carries its own bytes while the prefetch worker
    runs concurrently (pread carries its own offset)."""
    h, w, n = 16, 64, 64
    fname = tmp_path / f"clip_{w}x{h}_8b_420_709_30fps.yuv"
    fpx = w * h * 3 // 2
    with open(fname, "wb") as f:
        for i in range(n):  # frame i = constant byte i
            f.write(np.full(fpx, i, dtype=np.uint8).tobytes())
    r = native.NativeYuvReader(str(fname), w, h, 8, "420")
    rng = np.random.RandomState(1)
    for _ in range(20):  # mixed sequential + random access, racing prefetch
        start = int(rng.randint(0, n - 4))
        blk = r.read_block(start, 4)
        for k in range(4):
            assert (blk[k] == start + k).all(), f"frame {start + k} delivered foreign bytes"
        idx = [int(i) for i in rng.randint(0, n, 3)]
        got = r.read_indices(idx)
        for k, i in enumerate(idx):
            assert (got[k] == i).all(), f"frame {i} delivered foreign bytes"
    r.close()


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

def test_build_is_keyed_by_the_source_and_reused(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    path = native.build()
    assert os.path.isfile(path) and os.path.dirname(path) == str(tmp_path / "build")
    assert native._tag() in os.path.basename(path)
    mtime = os.stat(path).st_mtime_ns
    assert native.build() == path and os.stat(path).st_mtime_ns == mtime
    assert not [f for f in os.listdir(tmp_path / "build") if f.endswith(".tmp")]


def test_build_without_gxx_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()


def test_failed_build_raises_and_names_gxx(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "SRC", str(bad))
    with pytest.raises(RuntimeError, match="with g\\+\\+ failed"):
        native.build()
    assert not os.path.exists(tmp_path / "build") or not os.listdir(tmp_path / "build") \
        or all(f.endswith(".tmp") for f in os.listdir(tmp_path / "build"))


def test_source_is_a_copy_of_the_jax_package_s():
    """The port keeps its own copy: the same code under its own header."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    strip = lambda p: open(p).read().split("#include <atomic>", 1)[1]  # noqa: E731
    assert strip(native.SRC) == strip(os.path.join(here, "fovvideovdp_tpu", "native",
                                                   "fvvdp_io.cpp"))
