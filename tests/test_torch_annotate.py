"""The port's annotation writer and frame sources against the JAX
package's: `draw_tracks` byte-equal, the JPEG-directory writer
file-for-file equal, and the video writer and the video / webcam sources
driven through stub `cv2` and `imageio` modules put in `sys.modules`
(neither decoder is needed where the port runs)."""

import os
import sys
import types

import numpy as np
import pytest

from reid_tpu.tracking import annotate as jann
from reid_tpu.tracking import sources as jsrc
from reid_tpu_torch.tracking import annotate as tann
from reid_tpu_torch.tracking import sources as tsrc


def tracks(rng, n=6, h=90, w=120):
    tlwh = np.stack([rng.uniform(-5, w - 10, n), rng.uniform(-5, h - 10, n),
                     rng.uniform(5, 40, n), rng.uniform(10, 60, n)], 1)
    return (tlwh.astype(np.float32), rng.integers(1, 30, n),
            rng.random(n) < 0.8)


def test_draw_tracks_byte_equal():
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (90, 120, 3), np.uint8)
    for _ in range(3):
        tlwh, ids, valid = tracks(rng)
        got = tann.draw_tracks(frame, tlwh, ids, valid)
        want = jann.draw_tracks(frame, tlwh, ids, valid)
        assert got.dtype == np.uint8 and got.shape == frame.shape
        assert got.tobytes() == want.tobytes()
        assert not np.array_equal(got, frame)


def test_jpeg_directory_writer_equal(tmp_path):
    outs = {}
    for name, mod in (("port", tann), ("jax", jann)):
        w = mod.AnnotatedVideoWriter(str(tmp_path / name), fps=25)
        r = np.random.default_rng(2)
        for _ in range(4):
            w.write(r.integers(0, 256, (48, 64, 3), np.uint8), *tracks(
                r, h=48, w=64))
        w.close()
        outs[name] = sorted(os.listdir(tmp_path / name))
    assert outs["port"] == outs["jax"] == [f"{i:06d}.jpg"
                                           for i in range(1, 5)]
    for f in outs["port"]:
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes()


class FakeCapture:
    """cv2.VideoCapture over a list of BGR frames."""

    def __init__(self, frames, fps):
        self.frames, self.fps, self.i, self.released = frames, fps, 0, False

    def isOpened(self):
        return not self.released

    def read(self):
        if self.i >= len(self.frames):
            return False, None
        self.i += 1
        return True, self.frames[self.i - 1]

    def get(self, prop):
        return self.fps if prop == "FPS" else 0

    def release(self):
        self.released = True


class FakeWriter:
    def __init__(self, path, fourcc, fps, size):
        self.args, self.frames = (path, fourcc, fps, size), []

    def write(self, frame):
        self.frames.append(frame.copy())

    def release(self):
        pass


def stub_cv2(frames_bgr, fps=12.5):
    cv2 = types.ModuleType("cv2")
    cv2.opened, cv2.writers = [], []

    def capture(src):
        cv2.opened.append(src)
        return FakeCapture(frames_bgr, fps)

    def writer(*args):
        cv2.writers.append(FakeWriter(*args))
        return cv2.writers[-1]
    cv2.VideoCapture = capture
    cv2.VideoWriter = writer
    cv2.VideoWriter_fourcc = lambda *c: "".join(c)
    cv2.CAP_PROP_FPS = "FPS"
    return cv2


@pytest.mark.parametrize("source", ["clip.mp4", "0"],
                         ids=["video", "webcam"])
def test_video_and_webcam_sources_through_cv2(monkeypatch, source):
    rng = np.random.default_rng(3)
    bgr = [rng.integers(0, 256, (8, 10, 3), np.uint8) for _ in range(5)]
    got = {}
    for name, mod in (("port", tsrc), ("jax", jsrc)):
        cv2 = stub_cv2(bgr)
        monkeypatch.setitem(sys.modules, "cv2", cv2)
        got[name] = list(mod.iter_frames(source, max_frames=4))
        assert cv2.opened == [0 if source == "0" else source]
        got[name + "_fps"] = mod.source_fps(source)
    assert [i for i, _ in got["port"]] == [1, 2, 3, 4]
    for (i, a), (j, b) in zip(got["port"], got["jax"]):
        assert i == j and np.array_equal(a, b)
        assert np.array_equal(a, bgr[i - 1][..., ::-1])      # BGR -> RGB
    assert got["port_fps"] == got["jax_fps"] == (30 if source == "0"
                                                 else 12)


def test_video_source_falls_back_to_imageio(monkeypatch):
    rng = np.random.default_rng(4)
    rgba = [rng.integers(0, 256, (6, 7, 4), np.uint8) for _ in range(3)]
    imageio = types.ModuleType("imageio")
    imageio.v2 = types.ModuleType("imageio.v2")
    imageio.v2.get_reader = lambda path: iter(rgba)
    monkeypatch.setitem(sys.modules, "cv2", None)        # ImportError
    monkeypatch.setitem(sys.modules, "imageio", imageio)
    monkeypatch.setitem(sys.modules, "imageio.v2", imageio.v2)
    got = list(tsrc.iter_frames("clip.avi"))
    assert [i for i, _ in got] == [1, 2, 3]
    for (_, a), b in zip(got, rgba):
        assert np.array_equal(a, b[..., :3])
    assert tsrc.source_fps("clip.avi") == 30
    with pytest.raises(ValueError, match="unrecognized"):
        list(tsrc.iter_frames("not_a_source.txt"))


def test_video_writer_through_cv2(monkeypatch):
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (20, 30, 3), np.uint8) for _ in range(3)]
    cv2 = stub_cv2([])
    monkeypatch.setitem(sys.modules, "cv2", cv2)
    w = tann.AnnotatedVideoWriter("out.avi", fps=12)
    for fr in frames:
        w.write(fr, *tracks(rng, h=20, w=30))
    w.close()
    (vw,) = cv2.writers
    assert vw.args == ("out.avi", "MJPG", 12, (30, 20))
    assert len(vw.frames) == 3
    r = np.random.default_rng(5)
    for _ in frames:                  # the same draws: frames, then tracks
        r.integers(0, 256, (20, 30, 3), np.uint8)
    for fr, got in zip(frames, vw.frames):
        want = jann.draw_tracks(fr, *tracks(r, h=20, w=30))[..., ::-1]
        assert np.array_equal(got, want)                    # RGB -> BGR
