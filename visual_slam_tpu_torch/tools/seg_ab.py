#!/usr/bin/env python3
"""Kernel B5 (camera-table expand) of this checkout beside other builds of
`csrc/seg.cu`, timed in turns on one card.

    python3 visual_slam_tpu_torch/tools/seg_ab.py --other parent=PATH [--other LABEL=PATH ...]
                                                  [--rounds 3] [--iters 20] [--ablate] [--solve]

Each PATH is a seg.cu; it is built alone with this checkout's NVCC_FLAGS
into a temporary directory, which is removed afterwards, and called
through the `vslam_cam_expand` its source declares: (x, cam, out, C, N, K,
stream, device), or this checkout's signature with a launch geometry
(seg_kernel.ExpandGeometry), which it then gets from this checkout's
`expand_geometry` and launches through `seg_kernel._launch_expand`. Every
build is checked bit for bit against the plain PyTorch version at every
shape. The shapes are the keyframe BA's (12,64)->(12,16384), with
make_problem's padding slots on camera 0, and config #5's (12,5000) and
(6,5000) -> N = 4,194,304, with uniform random ids and with the path's own
(`build_loop_map(5000, 1 << 20, 4)`'s `cam`). At each, each other build
and this checkout's kernel are timed in turns (other, this, this, other),
`rounds` times, by CUDA events around calls queued behind a device-side
sleep and by torch.profiler's device time. Beside them: `index_select`
(one PyTorch call for the same function), the bound (each byte read and
written once over 3.35 TB/s), a write floor (`fill_` of a tensor of the
output's shape, queued events) and the launch floor, one launch of a
one-element `zero_()` timed the same ways. `--ablate` adds variants of
this checkout's geometry in the same turns: two 512-thread blocks an SM
(`t512`), 4-byte ids and stores (`scalar`), stores without the evict-first
hint (`keep`). `--solve` times a warm config-#5 `ba_large.optimize` (5 LM
x 8 CG) with each build's B5, in turns, by the profiler's summed device
time. Prints the card's name and power limit, then one JSON line: the
median ms of each build and variant at each shape, every reading, and the
bit checks.
"""
import argparse
import ctypes
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile

HBM_BYTES_PER_MS = 3.35e9  # the H100 SXM's published device-memory rate


def build_other(src: pathlib.Path, out_dir: pathlib.Path, label: str):
    """(library, takes_geometry) of seg.cu at `src`."""
    from visual_slam_tpu_torch.ops.kernels import build

    decl = re.search(r'extern "C" int vslam_cam_expand\((.*?)\)', src.read_text(), re.S)
    if decl is None:
        raise RuntimeError(f"{src} declares no vslam_cam_expand")
    n_params = decl.group(1).count(",") + 1
    current = build._SIGNATURES["vslam_cam_expand"]
    if n_params not in (8, len(current)):
        raise RuntimeError(f"{src}: vslam_cam_expand takes {n_params} parameters")
    out = out_dir / f"libseg_{label}.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr}")
    lib = ctypes.CDLL(str(out))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.vslam_cam_expand.argtypes = current if n_params > 8 else [P, P, P, I, L, I, P, I]
    lib.vslam_cam_expand.restype = ctypes.c_int
    return lib, n_params > 8


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[], metavar="LABEL=PATH")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--solve", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("seg_ab: no CUDA card", file=sys.stderr)
        return 1
    from visual_slam_tpu_torch.models import ba_large
    from visual_slam_tpu_torch.ops.kernels import build, seg_kernel
    from visual_slam_tpu_torch.utils.cuda_timing import device_ms, queued_ms
    from visual_slam_tpu_torch.utils.synthetic import build_loop_map

    dev = torch.device("cuda", 0)
    sms, l2 = seg_kernel._card(0)
    rng = np.random.default_rng(0)
    prob, _ = build_loop_map(5000, 1 << 20, 4, seed=0, device=dev)
    kfba = rng.integers(0, 64, (2048, 8)).astype(np.int32)
    kfba[:, 1:] = 0  # make_problem's layout: Q=8 slots a landmark, 7 of them padding
    ids = {"kfba": torch.from_numpy(kfba.reshape(-1)).to(dev),
           "uniform": torch.from_numpy(rng.integers(0, 5000, 1 << 22).astype(np.int32)).to(dev),
           "path": prob.cam}
    cases = {f"{name}_C{C}": (torch.from_numpy(rng.normal(size=(C, K)).astype(np.float32)).to(dev),
                              ids[name])
             for name, C, K in [("kfba", 12, 64), ("uniform", 12, 5000), ("uniform", 6, 5000),
                                ("path", 12, 5000), ("path", 6, 5000)]}

    def geometry(x, cam, **kw):
        return seg_kernel.expand_geometry(x.shape[0], cam.shape[0], sms, l2,
                                          cam.data_ptr() % 16 == 0)._replace(**kw)

    variants = {}
    if args.ablate:
        variants = {"t512": {"threads": 512, "grid_x": 2 * sms}, "scalar": {"vec4": False},
                    "keep": {"evict_first": False}}

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="seg_ab_"))
    try:
        def expand_with(lib, takes_geometry):
            if takes_geometry:
                return lambda x, cam: seg_kernel._launch_expand(lib, x, cam, geometry(x, cam))

            def old(x, cam):
                C, K = x.shape
                out = torch.empty((C, cam.shape[0]), dtype=torch.float32, device=dev)
                build.check(lib.vslam_cam_expand(
                    x.data_ptr(), cam.data_ptr(), out.data_ptr(), C, cam.shape[0], K,
                    torch.cuda.current_stream(dev).cuda_stream, 0), "vslam_cam_expand")
                return out
            return old

        expand = {"this": seg_kernel.cam_expand}
        builds = []
        for spec in args.other:
            label, path = spec.split("=", 1)
            expand[label] = expand_with(*build_other(pathlib.Path(path), tmp, label))
            builds.append(label)
        for label, kw in variants.items():
            expand[label] = lambda x, cam, kw=kw: seg_kernel._launch_expand(
                build.library(), x, cam, geometry(x, cam, **kw))
        others = [label for label in expand if label != "this"]

        bit_equal, geometries = {}, {}
        for case, (x, cam) in cases.items():
            want = seg_kernel.cam_expand_torch(x, cam).view(torch.int32)
            for label, fn in expand.items():
                bit_equal[f"{label}/{case}"] = bool(torch.equal(fn(x, cam).view(torch.int32), want))
            geometries[case] = geometry(x, cam)._asdict()
        if not all(bit_equal.values()):
            raise AssertionError(f"a build differs from the plain version: {bit_equal}")

        z = torch.zeros(1, device=dev)
        floor_fn = lambda: z.zero_()  # noqa: E731
        readings = {case: {label: {"queued": [], "profiler": []} for label in expand}
                    for case in cases}
        library = {case: [] for case in cases}
        write = {case: [] for case in cases}
        floor = {"queued": [], "profiler": []}

        def record(into, fn):
            into["queued"].append(queued_ms(fn, iters=args.iters))
            ms, how = device_ms(fn, iters=args.iters)
            if how == "profiler":  # else the window saw no device activity
                into["profiler"].append(ms)

        for _ in range(args.rounds):
            for case, (x, cam) in cases.items():
                fns = {label: (lambda fn=fn: fn(x, cam)) for label, fn in expand.items()}
                for label in others:
                    for who in (label, "this", "this", label):
                        record(readings[case][who], fns[who])
                idx = seg_kernel._slot_index(cam, x.shape[1])
                padded = torch.cat([x, torch.zeros((x.shape[0], 1), device=dev)], dim=1)
                library[case].append(queued_ms(lambda: padded.index_select(1, idx), iters=args.iters))
                buf = torch.empty((x.shape[0], cam.shape[0]), device=dev)
                write[case].append(queued_ms(lambda: buf.fill_(1.0), iters=args.iters))
            record(floor, floor_fn)

        solve = {}
        if args.solve:
            orig = seg_kernel.cam_expand
            solve = {label: [] for label in ["this", *builds]}
            run = lambda: ba_large.optimize(prob, n_iters=5, cg_iters=8, init_lambda=1e-2)  # noqa: E731
            try:
                for _ in range(args.rounds):
                    for label in builds:
                        for who in (label, "this", "this", label):
                            seg_kernel.cam_expand = expand[who]
                            ms, how = device_ms(run, iters=1)  # after one warm call
                            solve[who].append(ms if how == "profiler" else None)
            finally:
                seg_kernel.cam_expand = orig
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output")
    med = lambda v: statistics.median(v) if v else None  # noqa: E731
    median = {case: {label: {k: med(v) for k, v in r.items()} for label, r in by.items()}
              for case, by in readings.items()}
    bound = {case: 4 * (x.numel() + cam.numel() + x.shape[0] * cam.numel()) / HBM_BYTES_PER_MS
             for case, (x, cam) in cases.items()}
    print(json.dumps({"bit_equal": bit_equal, "median_ms": median,
                      "index_select_ms": {c: med(v) for c, v in library.items()},
                      "write_floor_ms": {c: med(v) for c, v in write.items()},
                      "bound_ms": bound, "launch_floor_ms": {k: med(v) for k, v in floor.items()},
                      "solve_device_ms": {k: med([v for v in r if v is not None])
                                          for k, r in solve.items()},
                      "geometry": geometries, "readings_ms": readings, "floor_readings_ms": floor,
                      "solve_readings_ms": solve, "index_select_readings_ms": library,
                      "order": "other, this, this, other per shape and round",
                      "iters": args.iters, "rounds": args.rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
