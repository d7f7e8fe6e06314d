"""vstab_torch's blocked streaming pipeline on the CPU: blocked = whole clip,
the reference's blocked output, and the resume state.

Tolerances (tiny random flow network, f32, 21x48x64 clip):
- blocked against the port's whole-clip `stabilize`: 2e-3 absolute on every
  pixel, as the reference's own tests hold its blocked path, and the same
  `max_disp` bucket;
- uint8 frames: the same, against `stabilize` on the frames / 255;
- against the reference's `stabilize_blocked`: within 1e-3 on at least
  99.9% of the pixels (the rest sit where the 0.999 validity threshold or a
  bilinear tap flips between the two f32 implementations).
"""

import dataclasses
import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

import vstab.core.config as jcfg
from vstab.flow.pwcnet import init_params
from vstab.pipeline_blocked import stabilize_blocked as stabilize_blocked_ref
import vstab_torch
from vstab_torch import pipeline_blocked as pb
from vstab_torch.core import config as tcfg
from vstab_torch.eval.synthetic import make_shaky_clip
from vstab_torch.render.render import pick_max_disp, residual_disp_bound
from vstab_torch.utils.checkpoint import params_from_jax

torch.set_num_threads(1)


def _cfg(mod, method="sparse_ls", crop="auto"):
    return mod.Config(
        flow=mod.FlowConfig(
            pyramid_channels=(8, 12, 16), estimator_channels=(16, 12),
            kernel_impl="xla", compute_dtype="float32", output_level=1,
        ),
        smooth=mod.SmoothConfig(method=method),
        render=mod.RenderConfig(crop_mode=crop, kernel_impl="xla"),
    )


@pytest.fixture(scope="module")
def clip():
    return make_shaky_clip(t=21, h=48, w=64, seed=5)[0]


@pytest.fixture(scope="module")
def params():
    jp = init_params(jax.random.PRNGKey(0), _cfg(jcfg).flow)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp))


def _blocked(frames, tp, cfg, b, resume_state=None):
    """`stabilize_blocked` on the CPU, with the stats of the sweeps."""
    out = np.empty(frames.shape, np.float32)

    def chunks():
        for i in range(0, frames.shape[0], b):
            yield frames[i : i + b], i

    def writer(blk, start):
        out[start : start + blk.shape[0]] = blk

    stats = pb._run_blocked(
        chunks, writer, frames.shape[0], tp, cfg, b, torch.device("cpu"), resume_state=resume_state
    )
    return out, stats


def _whole(frames, tp, cfg):
    out, diags = vstab_torch.stabilize(frames, tp, cfg, device="cpu")
    if cfg.smooth.method == "affine":
        path = diags["warps"].numpy()
    else:
        path = (diags["profiles"] - diags["smoothed"]).numpy()
    h, w = frames.shape[1:3]
    return out.numpy(), pick_max_disp(residual_disp_bound(path, h, w, cfg.smooth.method), cfg.render)


@pytest.mark.parametrize("method", ["affine", "sparse_ls"])
@pytest.mark.parametrize("crop", ["auto", "fixed", "none"])
def test_blocked_matches_whole_clip(clip, params, method, crop):
    cfg = _cfg(tcfg, method, crop)
    want, d = _whole(clip, params[1], cfg)
    got, stats = _blocked(clip, params[1], cfg, 8)
    assert stats["max_disp"] == d
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    assert set(stats) == {
        "frames", "block_len", "max_disp", "wall_s", "stage_s", "host_s", "pinned_bytes",
        "prefault_bytes", "fps_processed",
        "resume_cached_blocks",
    }
    assert set(stats["stage_s"]) == {"flow", "scale", "render"}
    assert (stats["frames"], stats["block_len"], stats["resume_cached_blocks"]) == (21, 8, 0)


def test_blocked_uneven_tail_and_entry_point(clip, params):
    """T no multiple of block_len (21 = 13 + 8): the tail block is padded and
    sliced. Through the public entry point."""
    cfg = _cfg(tcfg)
    want, _ = _whole(clip, params[1], cfg)
    got = vstab_torch.stabilize_blocked(clip, params[1], cfg, block_len=13, device="cpu")
    assert got.dtype == np.float32 and got.shape == clip.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_blocked_uint8_frames(clip, params):
    cfg = _cfg(tcfg, crop="fixed")
    u8 = (np.clip(clip, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    want, _ = _whole(u8.astype(np.float32) / 255.0, params[1], cfg)
    got = vstab_torch.stabilize_blocked(u8, params[1], cfg, block_len=8, device="cpu")
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_render_rechunk_matches_whole_clip(clip, params, monkeypatch):
    """A tiny pixel budget makes the render dispatches 3 frames while the
    motion blocks stay 8; the output must not change."""
    monkeypatch.setattr(pb, "_RENDER_PX_FRAMES_BUDGET", 3 * clip.shape[1] * clip.shape[2])
    cfg = _cfg(tcfg, "sparse_ls", "auto")
    want, _ = _whole(clip, params[1], cfg)
    shapes = []
    real = pb._block_render

    def spy(frames, *a, **kw):
        shapes.append(tuple(frames.shape))
        return real(frames, *a, **kw)

    monkeypatch.setattr(pb, "_block_render", spy)
    got, _ = _blocked(clip, params[1], cfg, 8)
    assert set(shapes) == {(3, 48, 64, 3)} and len(shapes) == 8  # 3+3+2 for a full block, 3+2 for the tail
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_blocked_stages_see_one_block_shape(params, monkeypatch):
    """The block stages only ever see [block_len(+1)]-shaped inputs, so peak
    device memory is O(block), not O(T)."""
    cfg = _cfg(tcfg, crop="fixed")
    frames, _ = make_shaky_clip(t=30, h=32, w=48, seed=2)
    seen = {"motion": [], "render": []}
    real_m, real_r = pb._block_motion, pb._block_render

    def motion(p, blk, c):
        seen["motion"].append(tuple(blk.shape))
        return real_m(p, blk, c)

    def render(fr, path_blk, *a, **kw):
        seen["render"].append((tuple(fr.shape), path_blk.shape[0]))
        return real_r(fr, path_blk, *a, **kw)

    monkeypatch.setattr(pb, "_block_motion", motion)
    monkeypatch.setattr(pb, "_block_render", render)
    vstab_torch.stabilize_blocked(frames, params[1], cfg, block_len=8, device="cpu")
    assert set(seen["motion"]) == {(9, 32, 48, 3)} and len(seen["motion"]) == 4
    assert set(seen["render"]) == {((8, 32, 48, 3), 8)} and len(seen["render"]) == 4


@pytest.mark.parametrize("method", ["affine", "sparse_ls"])
def test_blocked_matches_reference_blocked(clip, params, method):
    want = stabilize_blocked_ref(clip, params[0], _cfg(jcfg, method, "fixed"), block_len=8)
    got = vstab_torch.stabilize_blocked(clip, params[1], _cfg(tcfg, method, "fixed"), block_len=8, device="cpu")
    err = np.abs(got - np.asarray(want))
    assert (err <= 1e-3).mean() >= 0.999, (err.max(), (err > 1e-3).mean())


def test_blocked_needs_cuda_unless_told_cpu(clip, params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vstab_torch.stabilize_blocked(clip, params[1], _cfg(tcfg))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vstab_torch.stabilize_video_blocked("in.mp4", "out.mp4", params[1], _cfg(tcfg))


# --- resume state ----------------------------------------------------------


def _state_kw(tmp_path):
    src = tmp_path / "in.bin"
    if not src.exists():
        src.write_bytes(b"x" * 100)
    return dict(
        t=100, b=8, in_path=str(src), hw=(48, 64),
        params={"w": torch.ones((3, 3)), "b": torch.zeros(())},
    )


def test_resume_state_keeps_an_identical_run_and_survives_a_torn_block(tmp_path):
    root = str(tmp_path / "x.resume")
    kw = _state_kw(tmp_path)
    pb._ResumeState(root, tcfg.Config(), **kw).save_motion(0, np.zeros((7, 2)))
    st = pb._ResumeState(root, tcfg.Config(), **kw)
    assert st.load_motion(0) is not None and st.load_motion(8) is None
    assert sorted(os.listdir(root)) == ["meta.json", "motion_00000000.npy"]
    assert st.load_scale() is None
    st.save_scale(0.875)
    assert pb._ResumeState(root, tcfg.Config(), **kw).load_scale() == 0.875
    with open(os.path.join(root, "scale.json")) as f:
        assert json.load(f) == {"scale": 0.875}
    st.save_motion(8, np.ones((8, 2)))
    with open(os.path.join(root, "motion_00000008.npy"), "wb") as f:
        f.write(b"torn")
    assert st.load_motion(8) is None  # treated as missing, not a crash
    st.finalize()
    assert not os.path.exists(root)


@pytest.mark.parametrize("what", ["config", "frames", "block_len", "shape", "params", "input", "input_changed"])
def test_stale_resume_dir_is_wiped(tmp_path, what):
    root = str(tmp_path / "y.resume")
    kw = _state_kw(tmp_path)
    pb._ResumeState(root, tcfg.Config(), **kw).save_motion(0, np.zeros((7, 2)))
    cfg = tcfg.Config()
    if what == "config":
        cfg = dataclasses.replace(cfg, seed=1)
    elif what == "frames":
        kw["t"] = 200
    elif what == "block_len":
        kw["b"] = 16
    elif what == "shape":
        kw["hw"] = (96, 128)
    elif what == "params":
        kw["params"] = {"w": torch.full((3, 3), 2.0), "b": torch.zeros(())}
    elif what == "input":
        other = tmp_path / "other.bin"
        other.write_bytes(b"x" * 100)
        kw["in_path"] = str(other)
    else:
        with open(kw["in_path"], "ab") as f:  # same path, another size
            f.write(b"y")
    st = pb._ResumeState(root, cfg, **kw)
    assert st.load_motion(0) is None
    assert os.listdir(root) == ["meta.json"]


def test_params_digest_reads_names_shapes_dtypes_and_bytes():
    base = {"a": torch.arange(6.0).reshape(2, 3), "b": torch.zeros((), dtype=torch.bfloat16)}
    d = pb._params_digest(base)
    assert d == pb._params_digest(dict(reversed(list(base.items()))))  # order-free
    assert d != pb._params_digest({**base, "a": base["a"].reshape(3, 2)})
    assert d != pb._params_digest({**base, "a": base["a"].double()})
    assert d != pb._params_digest({"c": base["a"], "b": base["b"]})
    assert d != pb._params_digest({**base, "a": base["a"] + 1})


def test_cached_motion_blocks_are_loaded_not_recomputed(clip, params, tmp_path, monkeypatch):
    """A run dies at the third block's dispatch; the next run loads what was
    saved, computes the rest and gives the uninterrupted run's output."""
    cfg = _cfg(tcfg, crop="auto")
    want, _ = _blocked(clip, params[1], cfg, 8)
    root = str(tmp_path / "out.resume")
    kw = dict(t=21, b=8, hw=(48, 64), params=params[1])
    calls = []
    real = pb._block_motion

    def dies_at_third(p, blk, c):
        calls.append(1)
        if len(calls) == 3:
            raise KeyboardInterrupt
        return real(p, blk, c)

    monkeypatch.setattr(pb, "_block_motion", dies_at_third)
    with pytest.raises(KeyboardInterrupt):
        _blocked(clip, params[1], cfg, 8, pb._ResumeState(root, cfg, **kw))
    assert sorted(os.listdir(root)) == ["meta.json", "motion_00000000.npy"]

    calls.clear()

    def counts(p, blk, c):
        calls.append(1)
        return real(p, blk, c)

    monkeypatch.setattr(pb, "_block_motion", counts)
    got, stats = _blocked(clip, params[1], cfg, 8, pb._ResumeState(root, cfg, **kw))
    assert stats["resume_cached_blocks"] == 1 and len(calls) == 2
    assert "scale.json" in os.listdir(root)
    np.testing.assert_array_equal(got, want)


# --- the prefetch thread -----------------------------------------------------


def test_prefetch_passes_items_and_exceptions_on_and_stops_early():
    assert list(pb._prefetch(iter(range(7)), depth=2)) == list(range(7))

    def failing():
        yield 1
        raise ValueError("decode failed")

    with pytest.raises(ValueError, match="decode failed"):
        list(pb._prefetch(failing()))

    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    gen = pb._prefetch(endless(), depth=2)
    assert next(gen) == 0
    gen.close()  # the consumer leaves early: the producer must stop
    for th in threading.enumerate():
        if th.name == "vstab-decode":
            th.join(timeout=5)
            assert not th.is_alive()
    assert len(produced) <= 5


# --- faulting in the output ---------------------------------------------------


def _vstab_threads():
    return [th for th in threading.enumerate() if th.name.startswith("vstab-")]


def _no_vstab_thread_left():
    """No prefault thread is alive on return (they are joined); a decode
    thread stops within its 0.1 s poll once its generator is closed."""
    assert not [th for th in _vstab_threads() if th.name.startswith("vstab-prefault")]
    for th in _vstab_threads():
        th.join(timeout=5)
        assert not th.is_alive(), th.name


@pytest.mark.parametrize("rb", [None, 3])
def test_prefault_slices_are_the_render_sweeps_drains(clip, params, monkeypatch, rb):
    """The helper's slices are the frame ranges the render sweep drains, in
    order, and cover the clip: whole blocks of 8 (13 + 8 with block_len 13),
    and 3-frame dispatches cut from each block under a tiny pixel budget."""
    if rb is not None:
        monkeypatch.setattr(pb, "_RENDER_PX_FRAMES_BUDGET", rb * clip.shape[1] * clip.shape[2])
    t = clip.shape[0]
    for b in (8, 13):
        drained = []
        pb._run_blocked(lambda: ((clip[i : i + b], i) for i in range(0, t, b)),
                        lambda blk, start: drained.append((start, start + blk.shape[0])),
                        t, params[1], _cfg(tcfg, crop="fixed"), b, torch.device("cpu"))
        slices = pb._Prefault(np.empty(clip.shape, np.float32), b).slices
        assert slices == drained
        assert [s[0] for s in slices] == [0] + [s[1] for s in slices[:-1]] and slices[-1][1] == t
        assert max(z - a for a, z in slices) == (rb or b)


def test_the_drain_writes_a_slice_only_once_it_is_resident(clip, params, monkeypatch):
    """A helper slower than the motion sweep: each drained block still finds
    its slice's event set, and the drain's wait is the span `out_wait`."""
    real = pb._Prefault._touch

    def slow(self, lo, hi):
        time.sleep(0.3)
        real(self, lo, hi)

    monkeypatch.setattr(pb._Prefault, "_touch", slow)
    out = np.empty(clip.shape, np.float32)
    seen = []

    def writer(blk, start):
        seen.append((start, pf._ready[start].is_set()))
        out[start : start + blk.shape[0]] = blk

    with pb._Prefault(out, 8) as pf:
        stats = pb._run_blocked(lambda: ((clip[i : i + 8], i) for i in range(0, 21, 8)), writer,
                                21, params[1], _cfg(tcfg, crop="fixed"), 8, torch.device("cpu"),
                                prefault=pf)
    assert seen == [(0, True), (8, True), (16, True)]
    assert stats["prefault_bytes"] == out.nbytes and stats["host_s"]["out_wait"] > 0


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("offset", [0, 4, 4092])
def test_prefault_writes_every_page_and_the_last_element(monkeypatch, threads, offset):
    """An output whose frames, and whose start, do not fall on page
    boundaries: after the helper, every OS page it spans holds a written 0,
    its last element too, and each slice's event is set."""
    monkeypatch.setattr(pb, "_PREFAULT_THREADS", threads)
    shape = (23, 37, 53, 3)
    n = int(np.prod(shape))
    buf = np.full(n + 2048, np.nan, np.float32)
    out = buf.view(np.uint8)[offset : offset + 4 * n].view(np.float32).reshape(shape)
    with pb._Prefault(out, 8) as pf:
        for start, _ in pf.slices:
            pf.wait(start)
    assert all(pf._ready[start].is_set() for start, _ in pf.slices)
    assert [start for start, _ in pf.slices] == [0, 8, 16] and pf.nbytes == out.nbytes
    page, addr = os.sysconf("SC_PAGE_SIZE"), out.ctypes.data
    written = np.flatnonzero(out.reshape(-1) == 0)
    spanned = range(addr // page, (addr + out.nbytes - 1) // page + 1)
    assert set(((addr + 4 * written) // page).tolist()) == set(spanned)
    assert out.reshape(-1)[-1] == 0
    assert np.isnan(out).mean() > 0.99  # a page's worth of elements apart, not a fill
    _no_vstab_thread_left()


@pytest.mark.parametrize("caller_waits", [True, False])
def test_prefault_error_reaches_the_caller(monkeypatch, caller_waits):
    """A fault in the helper wakes a drain waiting on any slice and is raised
    there; a caller that never waits gets it on leaving the block."""
    real = pb._Prefault._touch

    def touch(self, lo, hi):
        if lo >= self._flat.size // 2:
            raise MemoryError("cannot fault in")
        real(self, lo, hi)

    monkeypatch.setattr(pb._Prefault, "_touch", touch)
    out = np.empty((21, 48, 64, 3), np.float32)
    with pytest.raises(MemoryError, match="cannot fault in"):
        with pb._Prefault(out, 8) as pf:
            if caller_waits:
                for start, _ in pf.slices:
                    pf.wait(start)
    _no_vstab_thread_left()


def test_a_call_that_raises_leaves_no_thread(clip, params, monkeypatch):
    """The render sweep fails mid-clip: the error is the caller's, and no
    prefault or decode thread outlives the call."""

    def render(*a, **kw):
        raise RuntimeError("render failed")

    monkeypatch.setattr(pb, "_block_render", render)
    with pytest.raises(RuntimeError, match="render failed"):
        vstab_torch.stabilize_blocked(clip, params[1], _cfg(tcfg, crop="fixed"), block_len=8,
                                      device="cpu")
    _no_vstab_thread_left()


def test_stats_count_the_prefaulted_output(tmp_path, clip, params, caplog):
    """`stabilize_blocked` faults in its whole output (`prefault_bytes` is
    its size, waits in `host_s.out_wait`); the file path owns no output
    array and faults in nothing."""
    pytest.importorskip("cv2")
    from vstab_torch.io.video import write_video

    caplog.set_level("INFO", logger="vstab_torch.blocked")
    cfg = _cfg(tcfg, crop="fixed")
    out = vstab_torch.stabilize_blocked(clip, params[1], cfg, block_len=8, device="cpu")
    (rec,) = [r for r in caplog.records if str(r.msg).startswith("blocked stabilize:")]
    stats = rec.args if isinstance(rec.args, dict) else rec.args[0]
    assert stats["prefault_bytes"] == out.nbytes == 21 * 48 * 64 * 3 * 4
    assert stats["host_s"]["out_wait"] >= 0
    src = str(tmp_path / "in.mp4")
    write_video(src, clip, fps=24.0)
    video = vstab_torch.stabilize_video_blocked(src, str(tmp_path / "out.mp4"), params[1], cfg,
                                                block_len=8, device="cpu")
    assert video["prefault_bytes"] == 0 and video["host_s"]["out_wait"] == 0.0


# --- file to file --------------------------------------------------------------


def test_video_file_roundtrip(tmp_path, clip, params):
    pytest.importorskip("cv2")
    from vstab_torch.io.video import probe_video, read_video, read_video_chunks, write_video

    src, dst = str(tmp_path / "in.mp4"), str(tmp_path / "out.mp4")
    write_video(src, clip, fps=24.0)
    back, fps = read_video(src)
    assert back.shape == clip.shape and abs(fps - 24.0) < 0.5
    assert np.mean(np.abs(back - clip)) < 0.1  # uint8 + lossy mp4v
    n, fps_p, hw = probe_video(src)
    assert (n, hw) == (21, (48, 64)) and abs(fps_p - 24.0) < 0.5
    chunks = list(read_video_chunks(src, chunk_frames=8, dtype="uint8"))
    assert [(c.shape[0], s, c.dtype) for c, s in chunks] == [(8, 0, np.uint8), (8, 8, np.uint8), (5, 16, np.uint8)]
    f32 = np.concatenate([c for c, _ in read_video_chunks(src, chunk_frames=8)])
    np.testing.assert_array_equal(f32, back)
    assert read_video(src, max_frames=5, stride=2)[0].shape[0] == 5
    with pytest.raises(FileNotFoundError):
        read_video(str(tmp_path / "missing.mp4"))

    cfg = _cfg(tcfg, crop="fixed")
    stats = vstab_torch.stabilize_video_blocked(src, dst, params[1], cfg, block_len=8, device="cpu")
    assert stats["frames"] == 21 and stats["input"] == src and stats["output"] == dst
    assert not os.path.exists(dst + ".resume")  # removed on success
    out, _ = read_video(dst)
    assert out.shape == clip.shape and np.isfinite(out).all()
    # the file path equals the in-memory path on the decoded uint8 frames,
    # up to the output's quantization and the codec
    u8 = np.concatenate([c for c, _ in chunks])
    mem = vstab_torch.stabilize_blocked(u8, params[1], cfg, block_len=8, device="cpu")
    assert np.mean(np.abs(out - mem)) < 0.05
    capped = vstab_torch.stabilize_video_blocked(
        src, dst, params[1], cfg, block_len=8, max_frames=11, resume=False, device="cpu")
    assert capped["frames"] == 11 and read_video(dst)[0].shape[0] == 11
