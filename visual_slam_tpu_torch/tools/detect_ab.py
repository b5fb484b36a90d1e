#!/usr/bin/env python3
"""Kernel B1 (and its B2 mode) of this checkout beside other builds of
`csrc/detect_blur.cu`, timed in turns on one card.

    python3 visual_slam_tpu_torch/tools/detect_ab.py --other parent=PATH [--other LABEL=PATH ...]
                                                     [--rounds 2] [--iters 50]

Each PATH is a detect_blur.cu with the same C entry point
(`vslam_detect_blur`, taking the batch count B after the three pointers;
a source from before the batch dimension needs the copy of this tool
from its own checkout); it is built alone with this checkout's NVCC_FLAGS
into a temporary directory, which is removed afterwards. Every build is
checked bit for bit against the plain PyTorch version (peaks, blur, and the
blur-off mode) at 480x640 on smoothed noise (border 16) and at 479x637 on
uniform noise (border 0). Then, at 480x640, each other build and this
checkout's kernel are timed in turns (other, this, this, other), `rounds`
times, in both modes and by two methods: torch.profiler's device time and
CUDA events around calls queued behind a device-side sleep. Beside them, a
copy floor: one PyTorch call (`img.repeat(2, 1)`) that reads the frame once
and writes two frames' worth, the bytes B1 moves, timed the same ways.
Prints the card's name and power limit, then one JSON line: the median ms
per call of each build, mode and method, and every reading.
"""
import argparse
import ctypes
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile


def build_other(src: pathlib.Path, out_dir: pathlib.Path, label: str):
    from visual_slam_tpu_torch.ops.kernels import build

    out = out_dir / f"libdetect_{label}.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.vslam_detect_blur.argtypes = build._SIGNATURES["vslam_detect_blur"]
    lib.vslam_detect_blur.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[], metavar="LABEL=PATH")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

    import numpy as np
    import torch
    from scipy import ndimage

    if not torch.cuda.is_available():
        print("detect_ab: no CUDA card", file=sys.stderr)
        return 1
    from visual_slam_tpu_torch.ops.kernels import build, detect_kernel
    from visual_slam_tpu_torch.utils.cuda_timing import device_ms, queued_ms

    dev = torch.device("cuda", 0)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="detect_ab_"))
    try:
        libs = {"this": build.library()}
        for spec in args.other:
            label, path = spec.split("=", 1)
            libs[label] = build_other(pathlib.Path(path), tmp, label)

        rng = np.random.default_rng(0)
        cases = [
            ("noise480x640_b16", ndimage.gaussian_filter(rng.uniform(0, 1, (480, 640)), 3.0), 16),
            ("raw479x637_b0", rng.uniform(0, 1, (479, 637)), 0),
        ]
        equal = {}
        for name, img_np, border in cases:
            img = torch.from_numpy(img_np.astype(np.float32)).to(dev)
            pp, bp = detect_kernel.corner_peaks_and_blur_torch(img, border=border)
            for label, lib in libs.items():
                pk, bk = detect_kernel._launch(img, 3, border, True, 4, 2.0, lib=lib)
                p2, _ = detect_kernel._launch(img, 3, border, False, 4, 2.0, lib=lib)
                torch.cuda.synchronize()
                equal[f"{label}/{name}"] = bool(torch.equal(pk, pp) and torch.equal(bk, bp)
                                                and torch.equal(p2, pp))
        if not all(v for k, v in equal.items() if k.startswith("this/")):
            raise AssertionError(f"this checkout's kernel differs from its plain version: {equal}")

        img = torch.from_numpy(cases[0][1].astype(np.float32)).to(dev)
        fns = {label: {mode: (lambda lib=lib, blur=(mode == "B1"):
                              detect_kernel._launch(img, 3, 16, blur, 4, 2.0, lib=lib))
                       for mode in ("B1", "B2")} for label, lib in libs.items()}
        copy_floor = lambda: img.repeat(2, 1)  # noqa: E731
        readings = {label: {m: {"profiler": [], "queued": []} for m in ("B1", "B2")} for label in libs}
        floor = {"profiler": [], "queued": []}

        def record(into, fn):
            ms, how = device_ms(fn, iters=args.iters)
            if how == "profiler":  # else the window saw no device activity
                into["profiler"].append(ms)
            into["queued"].append(queued_ms(fn, iters=args.iters))

        for _ in range(args.rounds):
            for label in libs:
                if label == "this":
                    continue
                for mode in ("B1", "B2"):
                    for who in (label, "this", "this", label):
                        fn = fns[who][mode]
                        record(readings[who][mode], fn)
            record(floor, copy_floor)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output")
    med = lambda v: statistics.median(v) if v else None  # noqa: E731
    median = {label: {m: {k: med(v) for k, v in r.items()} for m, r in modes.items()}
              for label, modes in readings.items()}
    print(json.dumps({"bit_equal": equal, "median_ms": median,
                      "copy_floor_ms": {k: med(v) for k, v in floor.items()},
                      "readings_ms": readings, "copy_floor_readings_ms": floor,
                      "order": "other, this, this, other per mode and round",
                      "shape": [480, 640], "iters": args.iters}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
