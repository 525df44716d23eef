"""CLI of the PyTorch port: the hard and soft flag sets of
chaq_sdfgen_tpu/cli.py.

Short flags mirror chaq_sdfgen (openmp/sdfgen.c:32-49): -i/-o/-s/-q/-f,
-a/-l/-n (argparse clusters them, so -al works). Long options mirror
chaq_sdfgen_opencl (opencl/main.cpp:362-444): --list-platforms,
--platform, --list-devices, --device, --log-level, --time, --two-channel.
Platforms are ``cuda`` (when a card is present) and ``cpu``. The default is
the first CUDA device; without a card the CLI runs only when asked for the
CPU (--platform cpu). --algorithm picks the distance core: exact (the
OpenMP binary's bytes), brute (the OpenCL binary's) or jfa (jump flood).
--soft runs the differentiable path: on the declared gray
range (--gray-range, default 0 255) where it lies inside the gamut of
--soft-tau and --soft-temperature, else as an undeclared range (a range
such as -1000000000 1000000000 forces it): the runtime gate up to spread 110 (band 112),
the composed path above. --soft-prec takes highest or high, and both run
the same float32 kernels (there is no lower-precision form to opt into).
A spread that the kernels refuse (EXACT above 2^30 - 3, BRUTE above 32766)
ends the run with one line on stderr and exit code 1. --shard-y/--shard-x/--halo-impl run the
hard algorithms, or with --soft the soft field, over a device mesh
(ShardingConfig): distinct cards on cuda (exit code 1 when there are too
few, or when --device selects another card than the first), logical shards
on the CPU. A soft run that the mesh tiers refuse (a --shard-x mesh
outside the declared-range kernels' tier, as in the JAX package) ends with
one line on stderr and exit code 1.

Usage:  python -m chaq_sdfgen_tpu_torch -i in.png -o out.png -s 100 -al
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from typing import List, Optional

import numpy as np

log = logging.getLogger("chaq_sdfgen_tpu_torch")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="chaq_sdfgen_tpu_torch",
        description="Signed-distance-field generator on PyTorch and CUDA "
        "(capabilities of chaquator/chaq-sdfgen).",
    )
    p.add_argument("-i", "--input", help="input file; '-' reads stdin")
    p.add_argument("-o", "--output", help="output file; '-' writes stdout")
    p.add_argument("-s", "--spread", type=int, default=64,
                   help="spread radius in pixels (default: 64)")
    p.add_argument("-q", "--quality", type=int, default=100,
                   help="jpg quality 1-100 (default: 100)")
    p.add_argument("-f", "--filetype", default=None,
                   help="force output filetype: png, bmp, tga, jpg "
                        "(default: deduced from output filename, png fallback)")
    p.add_argument("-a", "--asymmetric", action="store_true",
                   help="asymmetric spread (unsigned distance transform)")
    p.add_argument("-l", "--luminance", action="store_true",
                   help="test pixels by luminance instead of alpha")
    p.add_argument("-n", "--invert", action="store_true",
                   help="invert the threshold test")
    p.add_argument("--algorithm", choices=["exact", "brute", "jfa"], default="exact",
                   help="distance core: exact (OpenMP-binary parity), brute "
                        "(OpenCL-kernel parity), jfa (jump flood)")
    p.add_argument("--list-platforms", action="store_true",
                   help="list available platforms (cuda, cpu)")
    p.add_argument("--platform", default=None,
                   help="select platform by case-insensitive name substring")
    p.add_argument("--list-devices", action="store_true",
                   help="list the devices of the selected platform and exit")
    p.add_argument("--device", default=None,
                   help="select device by index or name substring")
    p.add_argument("--two-channel", action="store_true",
                   help="write gray+alpha output like the OpenCL binary "
                        "(opencl/main.cpp:166-199); default is 1-channel like "
                        "the OpenMP binary")
    p.add_argument("--log-level", default="critical",
                   choices=["trace", "debug", "info", "warn", "err", "critical", "off"],
                   help="log level (default: critical)")
    p.add_argument("--time", action="store_true", dest="time_kernel",
                   help="print the pipeline's device time per run (the slope "
                        "between 4 and 36 back-to-back runs, CUDA events) like "
                        "the OpenCL --time flag")
    p.add_argument("--soft", action="store_true",
                   help="differentiable soft pipeline: sigmoid threshold + "
                        "soft-min EDT (no reference analogue). Output is the "
                        "clamped soft byte map; --soft-field additionally "
                        "dumps the raw float signed field")
    p.add_argument("--soft-tau", type=float, default=1.0,
                   help="soft threshold temperature in pixel units (default: 1.0)")
    p.add_argument("--soft-temperature", type=float, default=0.5,
                   help="soft-min temperature T in squared-pixel units (default: 0.5)")
    p.add_argument("--soft-eps", type=float, default=1e-6,
                   help="sqrt smoothing epsilon (default: 1e-6)")
    p.add_argument("--soft-clamp", default="hard", choices=["hard", "tanh", "none"],
                   help="output clamping of the soft remap (default: hard)")
    p.add_argument("--soft-field", default=None, metavar="FILE.npy",
                   help="with --soft: also save the raw float32 signed field as .npy")
    p.add_argument("--soft-prec", default="highest", choices=("highest", "high"),
                   help="soft-path precision, accepted as in the JAX CLI: both "
                        "values run the port's float32 soft kernels (there is no "
                        "lower-precision form)")
    p.add_argument("--gray-range", nargs=2, type=float, default=(0.0, 255.0),
                   metavar=("LO", "HI"),
                   help="declared input-value bound for the soft path (default: "
                        "0 255, always valid for u8 images); a range outside "
                        "the declared-range kernels' gamut (e.g. -1000000000 "
                        "1000000000; older Pythons read -1e9 as an option) takes "
                        "the undeclared-range paths")
    p.add_argument("--shard-y", type=int, default=1, metavar="N",
                   help="shard image rows over N mesh devices "
                        "(ShardingConfig; 1 = unsharded)")
    p.add_argument("--shard-x", type=int, default=1, metavar="N",
                   help="shard image columns over N mesh devices "
                        "(2-D ('y','x') tile mesh)")
    p.add_argument("--halo-impl", default="ppermute",
                   choices=["ppermute", "rdma"],
                   help="halo-exchange implementation for sharded runs "
                        "(default: ppermute)")
    # the JAX CLI's compilation-cache switch: PyTorch runs eagerly, nothing
    # to cache, so it is accepted and ignored
    p.add_argument("--no-jit-cache", action="store_true", help=argparse.SUPPRESS)
    return p


_LEVELS = {
    "trace": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "err": logging.ERROR,
    "critical": logging.CRITICAL,
    "off": logging.CRITICAL + 10,
}


def _platforms() -> List[str]:
    import torch

    return (["cuda"] if torch.cuda.is_available() else []) + ["cpu"]


def _devices(platform: str):
    """(torch.device, name) pairs of a platform."""
    import torch

    if platform == "cuda":
        return [
            (torch.device("cuda", i), torch.cuda.get_device_name(i))
            for i in range(torch.cuda.device_count())
        ]
    return [(torch.device("cpu"), "cpu")]


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=_LEVELS[args.log_level], stream=sys.stderr,
                        format="[%(levelname)s] %(message)s")

    if args.list_platforms:
        for i, pname in enumerate(_platforms()):
            print(f"{i}: {pname}")
        return 0

    platform = _platforms()[0]
    if args.platform is None and platform != "cuda":
        print("No CUDA device found; pass --platform cpu to run on the CPU.", file=sys.stderr)
        return 1
    if args.platform is not None:
        matches = [n for n in _platforms() if args.platform.lower() in n.lower()]
        if not matches:
            print("Platform specified not found.", file=sys.stderr)
            return 1
        platform = matches[0]
        log.info("selected platform %s", platform)

    devs = _devices(platform)
    if args.list_devices:
        for i, (dev, name) in enumerate(devs):
            print(f"{i}: {name} ({platform})")
        return 0

    device = devs[0][0]
    if args.device is not None:
        if args.device.isdigit():
            idx = int(args.device)
            if idx >= len(devs):
                print(f"No device with index {idx}.", file=sys.stderr)
                return 1
            device = devs[idx][0]
        else:
            matches = [d for d, name in devs if args.device.lower() in name.lower()]
            if not matches:
                print(f"No device matching {args.device!r}.", file=sys.stderr)
                return 1
            device = matches[0]

    # validation mirrors openmp/sdfgen.c:229-244
    if not args.quality or args.quality > 100:
        print("Invalid value given for jpeg quality. Must be between 1-100", file=sys.stderr)
        return 1
    if args.spread < 1:
        print("Invalid value given for spread. Must be a positive integer.", file=sys.stderr)
        return 1
    if args.input is None:
        print("No input file specified.", file=sys.stderr)
        return 1
    if args.output is None:
        print("No output file specified.", file=sys.stderr)
        return 1

    if args.soft_field is not None and not args.soft:
        print("--soft-field requires --soft.", file=sys.stderr)
        return 1

    from chaq_sdfgen_tpu_torch.config import Algorithm, Channel, SdfConfig, ShardingConfig, SoftConfig
    from chaq_sdfgen_tpu_torch.models.sdf_model import SDFGenerator
    from chaq_sdfgen_tpu_torch.ops import band_conv, cuda_brute, cuda_edt, cuda_soft_mm, soft_front, soft_fused, softmin
    from chaq_sdfgen_tpu_torch.parallel import cuda_halo, sharded
    from chaq_sdfgen_tpu_torch.utils import imageio as iio

    t0 = time.perf_counter()
    try:
        img2ch = iio.load_gray_alpha(args.input)
    except Exception as e:  # any decode failure is the reference's one message
        print(f"Input file could not be opened. ({e})", file=sys.stderr)
        return 1
    log.info("loaded %s: %dx%d in %.3fs", args.input, img2ch.shape[1], img2ch.shape[0],
             time.perf_counter() - t0)

    cfg = SdfConfig(
        spread=args.spread,
        asymmetric=args.asymmetric,
        channel=Channel.LUMINANCE if args.luminance else Channel.ALPHA,
        invert=args.invert,
        algorithm=Algorithm(args.algorithm),
    )
    soft_cfg = None
    if args.soft:
        soft_cfg = SoftConfig(
            tau=args.soft_tau,
            temperature=args.soft_temperature,
            eps=args.soft_eps,
            clamp=args.soft_clamp,
            gray_range=tuple(args.gray_range),
        )
    # the hard kernels' range of spreads (the soft path and JFA take any)
    top = {Algorithm.EXACT: cuda_edt.MAX_BAND - (cfg.effective_band - cfg.spread),
           Algorithm.BRUTE: cuda_brute.MAX_SPREAD}.get(cfg.algorithm)
    if soft_cfg is None and top is not None and cfg.spread > top:
        print(f"Invalid value given for spread. Must be at most {top} for --algorithm {args.algorithm}.",
              file=sys.stderr)
        return 1
    shard_cfg = None
    if args.shard_y > 1 or args.shard_x > 1 or args.halo_impl != "ppermute":
        if args.shard_x > 1:
            shard_cfg = ShardingConfig(mesh_shape=(args.shard_y, args.shard_x), axis_names=("y", "x"),
                                       halo_impl=args.halo_impl)
        else:
            shard_cfg = ShardingConfig(mesh_shape=(args.shard_y,), axis_names=("y",),
                                       halo_impl=args.halo_impl)
        n_dev = len(devs) if platform == "cuda" else args.shard_y * args.shard_x
        if args.shard_y * args.shard_x > n_dev:
            print(f"--shard-y/--shard-x need {args.shard_y * args.shard_x} devices, have {n_dev}.",
                  file=sys.stderr)
            return 1
        if device != devs[0][0]:
            print(f"--shard-y/--shard-x run over the cards from {devs[0][0]} on; --device selected {device}.",
                  file=sys.stderr)
            return 1
    gen = SDFGenerator(cfg, soft=soft_cfg, sharding=shard_cfg, device=device)
    t0 = time.perf_counter()
    try:
        out = gen.generate(img2ch).cpu().numpy()
    except sharded.XShardingRefused as e:  # a mesh the soft tiers refuse, as JAX's
        print(f"--soft over this mesh: {e}.", file=sys.stderr)
        return 1
    log.info("sdf computed in %.3fs on %s (first call: includes device and kernel start-up)",
             time.perf_counter() - t0, device)
    if args.soft_field is not None:
        np.save(args.soft_field, gen.generate_field(img2ch).cpu().numpy())
        log.info("saved raw soft field to %s", args.soft_field)
    if args.time_kernel:
        print(f"Kernel timing: {gen.kernel_time(img2ch):.6f} sec", file=sys.stderr)
    log.info("kernel launches %s",
             json.dumps({**cuda_edt.LAUNCHES, **cuda_brute.LAUNCHES, **cuda_soft_mm.LAUNCHES,
                         **soft_fused.LAUNCHES, **softmin.LAUNCHES, **band_conv.LAUNCHES,
                         **cuda_halo.LAUNCHES, **soft_front.LAUNCHES}))

    t0 = time.perf_counter()
    try:
        if args.two_channel:
            iio.write_gray_alpha(out, args.output, filetype=args.filetype, quality=args.quality)
        else:
            iio.write_gray(out, args.output, filetype=args.filetype, quality=args.quality)
    except ValueError as e:
        print(f"Invalid filetype specified. ({e})", file=sys.stderr)
        return 1
    log.info("wrote %s in %.3fs", args.output, time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
