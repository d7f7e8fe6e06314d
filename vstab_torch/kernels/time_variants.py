"""Time variants of the f32 cost volume, its backward, the feature warp and
`vwarp` beside the sources as they stand, on one card.

    python -m vstab_torch.kernels.time_variants [--parent DIR] [--only KERNEL ...] [--ptxas]

Run from the root of the repository (it takes `_time_ms` and the memory
rate from `chip_smoke.py`). A variant is a source of `csrc/` with some of its
tuning constants replaced (`VARIANTS` below); `--parent DIR` adds the sources
of another `csrc/` directory, e.g. an earlier commit's unpacked with
`git archive`, under the name "parent". All libraries are built in parallel
into `vstab_torch/_build/variants/`, each is held against the plain version
once, and then all are timed in turns (parent, current, variants, current,
parent) at the main path's shapes, so that every comparison is made on one
card within one call. One JSON line per shape; for the f32 cost volume and
its backward also one line per library with the sum of its times over the
trainer's five levels (one launch each a training step). `--only` times
some of `cost_volume_f32`, `cost_volume_bwd`, `bilinear_warp`, `vwarp`;
`--ptxas` builds the cost volume with `-Xptxas -v` and prints each
library's f32 forward and backward kernels' registers and spills.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch
import torch.nn.functional as F

from vstab_torch.kernels import _build
from vstab_torch.kernels.cost_volume import cost_volume_backward_plain, cost_volume_plain
from vstab_torch.kernels.warp import bilinear_warp_plain
from vstab_torch.kernels.warp1d import vwarp_plain

OUT = os.path.join(_build.BUILD_DIR, "variants")
# name -> (source, [(constant's definition, its replacement), ...])
VARIANTS = {
    # Probes of the backward (named probe_*: timed, not checked, since they
    # leave parts of the work out on purpose): no sums, no g values read in
    # the sums, no g staged, no band vectors read in the sums.
    "probe_bwd_no_sums": ("cost_volume", [("    if (ch < c) {\n      for (int dyi", "    if (ch < 0) {\n      for (int dyi")]),
    "probe_bwd_no_g_reads": ("cost_volume", [
        ("const float gv = WRT_F2 ? g_at(gj + 2 * R - e) : g_at(grow + p * ND + e);", "const float gv = 1.f + e;")]),
    "probe_bwd_no_g_staged": ("cost_volume", [("stage_g<Cfg, R, WRT_F2, T>(gs, g, y0, x0, h, w);", "")]),
    "probe_bwd_no_band_reads": ("cost_volume", [
        ("load_staged<T>(xrow + j * PITCH, xv);", "xv[0] = xv[1] = xv[2] = xv[3] = xrow[0] + j;")]),
    **{
        f"warp_{tx}x{ty}": ("warp", [("BW_TX = 128", f"BW_TX = {tx}"), ("BW_TY = 2", f"BW_TY = {ty}")])
        for tx, ty in ((256, 1), (64, 4), (128, 1), (64, 2))
    },
    # floats a thread a chunk, chunks a block: 1 chunk a block is "no loop"
    **{
        f"vwarp_per{per}_chunks{chunks}": (
            "warp1d", [("VW_PER = 4", f"VW_PER = {per}"), ("VW_CHUNKS = 4", f"VW_CHUNKS = {chunks}")])
        for per, chunks in ((1, 1), (2, 1), (4, 1), (8, 1), (2, 4), (2, 9), (4, 8), (8, 4))
    },
}
WARP_SHAPES = ((8, 192, 320, 32), (8, 96, 160, 64), (8, 48, 80, 96), (8, 24, 40, 128))
# The trainer's five pyramid levels (a batch of 8 at 192x256), then the f32
# serving middle and finest levels of the 720p clip.
CV_TRAIN_SHAPES = ((8, 48, 64, 32), (8, 24, 32, 64), (8, 12, 16, 96), (8, 6, 8, 128), (8, 3, 4, 196))
CV_SHAPES = CV_TRAIN_SHAPES + ((8, 48, 80, 96), (8, 192, 320, 32))
# The backward: the trainer's five levels in f32, then the 720p level in bf16.
CV_BWD_SHAPES = tuple((s, torch.float32) for s in CV_TRAIN_SHAPES) + (((8, 192, 320, 32), torch.bfloat16),)
# kernel timed -> its source in csrc/
TIMED = {"cost_volume_f32": "cost_volume", "cost_volume_bwd": "cost_volume", "bilinear_warp": "warp",
         "vwarp": "warp1d"}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_CV_ARGS = [_PTR] * 3 + [_INT] * 6 + [_PTR]
_CV_BWD_ARGS = [_PTR] * 5 + [_INT] * 6 + [_PTR]
_WARP_ARGS = [_PTR] * 3 + [_INT] * 4 + [ctypes.c_float] + [_INT] * 2 + [_PTR]
_VWARP_ARGS = [_PTR] * 3 + [_INT] * 4 + [ctypes.c_float, _INT, _PTR]


def _build_all(parent, sources, ptxas):
    os.makedirs(OUT, exist_ok=True)
    jobs = {"current": {s: os.path.join(_build.CSRC, f"{s}.cu") for s in sources}}
    if parent:
        jobs["parent"] = {s: os.path.join(parent, f"{s}.cu") for s in sources}
    for name, (source, subs) in VARIANTS.items():
        if source not in sources:
            continue
        with open(os.path.join(_build.CSRC, f"{source}.cu")) as f:
            text = f.read()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {source}.cu no longer defines {old!r}")
            text = text.replace(old, new)
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        jobs[name] = {source: path}
    procs = []
    for name, paths in jobs.items():
        for source, path in paths.items():
            so = os.path.join(OUT, f"{name}-{source}.so")
            include = parent if name == "parent" else _build.CSRC
            verbose = ["-Xptxas", "-v"] if ptxas and source == "cost_volume" else []
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *verbose, "-I", include, "-o", so, path]
            procs.append((name, source, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, source, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} ({source}.cu) did not build:\n{log}")
        libs.setdefault(source, {})[name] = ctypes.CDLL(so)
        if ptxas and source == "cost_volume":
            _print_ptxas(name, log)
    return libs


_PTXAS_KERNELS = ("cost_volume_f32_kernel", "cost_volume_bwd_kernel", "cost_volume_bwd_element_kernel")


def _print_ptxas(name, log):
    """One JSON line per f32 cost-volume kernel and backward kernel in
    ptxas's report: its name, template arguments (the forward: R, TH, NXG,
    KS, CQ; the backward: R, TH, NXG, NDY after the dtype, or V), registers
    and spills."""
    entry = kernel = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            kernel = next((k for k in _PTXAS_KERNELS if re.search(rf"\d{k}I", m.group(1))), None)
            entry = m.group(1) if kernel else None
            stores = loads = None
        if entry is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        regs = re.search(r"Used (\d+) registers", line)
        if spill:
            stores, loads = int(spill.group(1)), int(spill.group(2))
        if regs:
            rest = entry.split(kernel, 1)[1]
            args = [int(a) for a in re.findall(r"Li(\d+)E", rest)]
            dtype = "bf16" if "bfloat16" in rest else "f32"
            print(json.dumps({"ptxas": name, "kernel": kernel, "dtype": dtype, "template_args": args,
                              "registers": int(regs.group(1)), "spill_stores": stores,
                              "spill_loads": loads}), flush=True)
            entry = None


def _order(libs):
    middle = [k for k in libs if k not in ("current", "parent")]
    ends = [k for k in ("parent", "current") if k in libs]
    return ends + middle + ends[::-1]


def _call(lib, symbol, argtypes, *args):
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = argtypes, _INT
    err = fn(*args)
    if err:
        raise RuntimeError(f"{symbol}: CUDA launch failed ({err})")


def _time_cost_volume(libs, g, stream, time_ms, hbm):
    """The f32 cost volume, r=4, at CV_SHAPES: every library held to
    `cost_volume_plain` (atol 1e-5), then timed in turns; the bound is its
    bytes over the card's memory rate `hbm`."""
    sums = {}
    for shape in CV_SHAPES:
        n, h, w, c = shape
        f1 = torch.randn(shape, generator=g, device="cuda")
        f2 = torch.randn(shape, generator=g, device="cuda")
        want = cost_volume_plain(f1, f2, 4)
        out = torch.empty_like(want)
        times = []
        for name in _order(libs):
            def run():
                _call(libs[name], "vstab_cost_volume", _CV_ARGS, f1.data_ptr(), f2.data_ptr(),
                      out.data_ptr(), n, h, w, c, 4, 0, stream)
            out.zero_()
            run()
            torch.testing.assert_close(out, want, rtol=0, atol=1e-5)
            times.append((name, time_ms(run)))
        bound_ms = (2 * f1.numel() + out.numel()) * 4 / hbm * 1e3
        print(json.dumps({"kernel": "cost_volume_f32", "shape": shape, "bound_ms": bound_ms, "ms": times}),
              flush=True)
        if shape in CV_TRAIN_SHAPES:
            _sum_by_turn(sums, times)
        del f1, f2, want, out
    for name, by_turn in sums.items():
        print(json.dumps({"kernel": "cost_volume_f32", "library": name,
                          "train_levels_sum_ms_by_turn": by_turn}), flush=True)


def _sum_by_turn(sums, times):
    """Add one shape's times to each library's sums, one sum per turn
    (parent and current are timed twice)."""
    seen = {}
    for name, ms in times:
        turn = seen[name] = seen.get(name, -1) + 1
        by_turn = sums.setdefault(name, [])
        if turn == len(by_turn):
            by_turn.append(0.0)
        by_turn[turn] += ms


def _time_cost_volume_bwd(libs, g, stream, time_ms, hbm):
    """The cost volume's backward, r=4, both gradients in one launch, at
    CV_BWD_SHAPES: every library held to `cost_volume_backward_plain` within
    1e-5 (f32) or 2^-7 (bf16) of each gradient's largest value, then timed in
    turns; the bound is its bytes (g, f1, f2 read, df1, df2 written) over the
    card's memory rate `hbm`."""
    sums = {}
    for shape, dtype in CV_BWD_SHAPES:
        n, h, w, c = shape
        f1 = torch.randn(shape, generator=g, device="cuda").to(dtype)
        f2 = torch.randn(shape, generator=g, device="cuda").to(dtype)
        gout = torch.randn((n, h, w, 81), generator=g, device="cuda").to(dtype)
        want = cost_volume_backward_plain(gout, f1, f2, 4)
        df1, df2 = torch.empty_like(f1), torch.empty_like(f2)
        rel = 2.0**-7 if dtype == torch.bfloat16 else 1e-5
        code = _build.DTYPE_CODES[dtype]
        times = []
        for name in _order(libs):
            def run():
                _call(libs[name], "vstab_cost_volume_bwd", _CV_BWD_ARGS, gout.data_ptr(), f1.data_ptr(),
                      f2.data_ptr(), df1.data_ptr(), df2.data_ptr(), n, h, w, c, 4, code, stream)
            df1.zero_(), df2.zero_()
            run()
            for got, ref in zip((df1, df2), want) if not name.startswith("probe_") else ():
                err = float((got.float() - ref.float()).abs().max())
                tol = rel * float(ref.float().abs().max())
                if not err <= tol:
                    raise AssertionError(f"{name} cost_volume_bwd {shape}: max error {err:.3e} over {tol:.3e}")
            times.append((name, time_ms(run)))
        bound_ms = (gout.numel() + 4 * f1.numel()) * f1.element_size() / hbm * 1e3
        print(json.dumps({"kernel": "cost_volume_bwd", "shape": shape, "dtype": str(dtype).split(".")[1],
                          "bound_ms": bound_ms, "ms": times}), flush=True)
        if dtype == torch.float32 and shape in CV_TRAIN_SHAPES:
            _sum_by_turn(sums, times)
        del f1, f2, gout, want, df1, df2
    for name, by_turn in sums.items():
        print(json.dumps({"kernel": "cost_volume_bwd", "library": name,
                          "train_levels_sum_ms_by_turn": by_turn}), flush=True)


def main() -> int:
    from chip_smoke import _hbm_rate, _time_ms
    from vstab_torch.bench import card as _card

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another csrc/ directory to time beside this one")
    ap.add_argument("--only", nargs="+", choices=sorted(TIMED), default=sorted(TIMED),
                    help="kernels to time (default: all)")
    ap.add_argument("--ptxas", action="store_true",
                    help="print the f32 cost volume's and the backward's registers and spills")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_variants: torch sees no CUDA device", file=sys.stderr)
        return 2
    print(_card(), flush=True)
    libs = _build_all(args.parent, sorted({TIMED[k] for k in args.only}), args.ptxas)
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(0)

    hbm = _hbm_rate(torch.cuda.get_device_name(0))
    if "cost_volume_f32" in args.only:
        _time_cost_volume(libs["cost_volume"], g, stream, _time_ms, hbm)
    if "cost_volume_bwd" in args.only:
        _time_cost_volume_bwd(libs["cost_volume"], g, stream, _time_ms, hbm)
    for shape in WARP_SHAPES if "bilinear_warp" in args.only else ():
        n, h, w, c = shape
        img = torch.randn(shape, generator=g, device="cuda").bfloat16()
        flow = (torch.rand((n, h, w, 2), generator=g, device="cuda") * 24 - 12).bfloat16()
        want = bilinear_warp_plain(img, flow.clamp(-8, 8)).float()
        out = torch.empty_like(img)
        times = []
        for name in _order(libs["warp"]):
            def run():
                _call(libs["warp"][name], "vstab_bilinear_warp", _WARP_ARGS, img.data_ptr(),
                      flow.data_ptr(), out.data_ptr(), n, h, w, c, 8.0, 1, 1, stream)
            out.zero_()
            run()
            torch.testing.assert_close(out.float(), want, rtol=2.0**-7, atol=1e-5)
            times.append((name, _time_ms(run)))
        print(json.dumps({"kernel": "bilinear_warp", "shape": shape, "ms": times}), flush=True)

    if "vwarp" not in args.only:
        return 0
    d = 127
    coarse = torch.rand((48, 1, 12, 16), generator=g, device="cuda") * 2 * d - d
    for c in (3, 1):
        shape = (48, 720, 1280 + 2 * (d + 1), c)
        x = torch.rand(shape, generator=g, device="cuda")
        fields = {
            "random": (torch.rand(shape[:3], generator=g, device="cuda") * 2.4 * d - 1.2 * d).contiguous(),
            "smooth": F.interpolate(coarse, size=shape[1:3], mode="bilinear", align_corners=False)[:, 0].contiguous(),
            "smooth x 0.3": F.interpolate(0.3 * coarse, size=shape[1:3], mode="bilinear", align_corners=False)[:, 0].contiguous(),
        }
        out = torch.empty_like(x)
        for kind, field in fields.items():
            for mode in ("wrap", "edge") if c == 3 else ("wrap",):
                want = vwarp_plain(x, field, d, mode)
                times = []
                for name in _order(libs["warp1d"]):
                    def run():
                        _call(libs["warp1d"][name], "vstab_vwarp", _VWARP_ARGS, x.data_ptr(),
                              field.data_ptr(), out.data_ptr(), *shape, float(d),
                              int(mode == "wrap"), stream)
                    out.zero_()
                    run()
                    torch.testing.assert_close(out, want, rtol=0, atol=1e-5)
                    times.append((name, _time_ms(run)))
                print(json.dumps({"kernel": "vwarp", "shape": shape, "field": kind, "mode": mode,
                                  "ms": times}), flush=True)
                del want
    return 0


if __name__ == "__main__":
    sys.exit(main())
