"""Time variants of the feature warp and of `vwarp` beside the sources as
they stand, on one card.

    python -m vstab_torch.kernels.time_variants [--parent DIR]

Run from the root of the repository (it takes `_time_ms` and the card line
from `chip_smoke.py`). A variant is a source of `csrc/` with some of its
tuning constants replaced (`VARIANTS` below); `--parent DIR` adds the sources
of another `csrc/` directory, e.g. an earlier commit's unpacked with
`git archive`, under the name "parent". All libraries are built in parallel
into `vstab_torch/_build/variants/`, each is held against the plain version
once, and then all are timed in turns (parent, current, variants, current,
parent) at the main path's shapes, so that every comparison is made on one
card within one call. One JSON line per shape.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

from vstab_torch.kernels import _build
from vstab_torch.kernels.warp import bilinear_warp_plain
from vstab_torch.kernels.warp1d import vwarp_plain

OUT = os.path.join(_build.BUILD_DIR, "variants")
# name -> (source, [(constant's definition, its replacement), ...])
VARIANTS = {
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
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_WARP_ARGS = [_PTR] * 3 + [_INT] * 4 + [ctypes.c_float] + [_INT] * 2 + [_PTR]
_VWARP_ARGS = [_PTR] * 3 + [_INT] * 4 + [ctypes.c_float, _INT, _PTR]


def _build_all(parent):
    os.makedirs(OUT, exist_ok=True)
    jobs = {"current": {s: os.path.join(_build.CSRC, f"{s}.cu") for s in ("warp", "warp1d")}}
    if parent:
        jobs["parent"] = {s: os.path.join(parent, f"{s}.cu") for s in ("warp", "warp1d")}
    for name, (source, subs) in VARIANTS.items():
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
    for name, sources in jobs.items():
        for source, path in sources.items():
            so = os.path.join(OUT, f"{name}-{source}.so")
            include = parent if name == "parent" else _build.CSRC
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", include, "-o", so, path]
            procs.append((name, source, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, source, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} ({source}.cu) did not build:\n{log}")
        libs.setdefault(source, {})[name] = ctypes.CDLL(so)
    return libs


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


def main() -> int:
    from chip_smoke import _card, _time_ms

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another csrc/ directory to time beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_variants: torch sees no CUDA device", file=sys.stderr)
        return 2
    print(_card(), flush=True)
    libs = _build_all(args.parent)
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(0)

    for shape in WARP_SHAPES:
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
