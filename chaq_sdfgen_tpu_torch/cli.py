"""CLI of the PyTorch port: the hard flag set of chaq_sdfgen_tpu/cli.py.

Short flags mirror chaq_sdfgen (openmp/sdfgen.c:32-49): -i/-o/-s/-q/-f,
-a/-l/-n (argparse clusters them, so -al works). Long options mirror
chaq_sdfgen_opencl (opencl/main.cpp:362-444): --list-platforms,
--platform, --list-devices, --device, --log-level, --time, --two-channel.
Platforms are ``cuda`` (when a card is present) and ``cpu``; the default
device is the first CUDA device when there is one. --algorithm offers only
``exact`` until BRUTE and JFA are ported.

Usage:  python -m chaq_sdfgen_tpu_torch -i in.png -o out.png -s 100 -al
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from typing import List, Optional

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
    p.add_argument("--algorithm", choices=["exact"], default="exact",
                   help="distance core: exact (OpenMP-binary parity)")
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
                   help="print the pipeline's device time (median of 10 runs, "
                        "CUDA events) like the OpenCL --time flag")
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

    from chaq_sdfgen_tpu_torch.config import Algorithm, Channel, SdfConfig
    from chaq_sdfgen_tpu_torch.models.sdf_model import SDFGenerator
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
    gen = SDFGenerator(cfg, device=device)
    t0 = time.perf_counter()
    out = gen.generate(img2ch).cpu().numpy()
    log.info("sdf computed in %.3fs on %s (first call: includes device and kernel start-up)",
             time.perf_counter() - t0, device)
    if args.time_kernel:
        print(f"Kernel timing: {gen.kernel_time(img2ch):.6f} sec", file=sys.stderr)

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
