"""``python -m deepfly3d_torch.cli RECORDING`` — the command-line entry point.

Counterpart of ``deepfly3d_tpu/cli.py`` with its whole flag surface: the
reference's options (default ``<input>_df3d`` output folder, recursive and
from-file folder lists with per-folder error isolation, KeyboardInterrupt
stops the batch), ``--solver``, ``--soft-argmax``, ``--ba-huber-px``,
``--checkpoint``, ``--streaming`` / ``--no-streaming``, ``--profile``
(``fly``, or ``h36m``: the 4-camera 17-joint human profile) and
``--calib-prior``, ``--video-2d`` / ``--video-3d``, plus ``--device`` (default
``cuda``; ``cpu`` runs every kernel's plain version).  A run goes setup ->
pose2d -> save -> calibrate (bundle adjustment: ``parity``, or ``lm`` with
``--ba-huber-px``) -> save -> video2d -> video3d; with
``--skip-pose-estimation`` it calibrates the resumed 2D points.  The network
runs on ``--device``; ``--soft-argmax`` refines its argmax cells on the same
device; triangulation, bundle adjustment and Procrustes run in float64 on
the host, and the videos are drawn on the host (``viz/``).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from pathlib import Path

from deepfly3d_torch import logger


def main(argv=None) -> int:
    args = parse_cli_args(argv)
    setup_logger(args)

    if args.debug:
        return print_debug(args)

    if args.from_file and args.recursive:
        logger.error(
            'Error: choose an input method between "from file" and '
            '"recursive" but not both.'
        )
        return 1
    if args.recursive:
        return run_recursive(args)
    if args.from_file:
        return run_from_file(args)
    return run(args)


def setup_logger(args):
    log = logger.getLogger()
    if not log.handlers:
        handler = logging.StreamHandler()
        handler.setLevel(logging.DEBUG)
        log.addHandler(handler)
    log.setLevel(logging.WARNING)
    if args.verbose:
        log.setLevel(logging.INFO)
    if args.verbose2:
        log.setLevel(logging.DEBUG)


def parse_cli_args(argv=None):
    parser = argparse.ArgumentParser(description="DeepFly3D pose estimation (PyTorch/CUDA)")
    parser.add_argument("-v", "--verbose", action="store_true",
                        help="Enable info output (such as progress bars)")
    parser.add_argument("-vv", "--verbose2", action="store_true",
                        help="Enable debug output")
    parser.add_argument("-d", "--debug", action="store_true",
                        help="Displays the argument list for debugging purposes")
    parser.add_argument("input_folder", metavar="INPUT",
                        help="Without additional arguments, a folder containing unlabeled images.")
    parser.add_argument("--output-folder", default=None,
                        help="The name of the folder where results will be written. "
                             "If not specified, a folder named <INPUT>_df3d is used.")
    parser.add_argument("-r", "--recursive", action="store_true",
                        help="INPUT is a folder. Successively use its subfolders named 'images/'")
    parser.add_argument("-f", "--from-file", action="store_true",
                        help="INPUT is a text-file, where each line names a folder. "
                             "Successively use the listed folders.")
    parser.add_argument("-x", "--delete-images", action="store_true",
                        help="Delete image files after running. Only deletes if a "
                             "corresponding .mp4 exists in the folder.")
    parser.add_argument("-n", "--num-images-max", type=int, default=0,
                        help="Maximal number of images to process. 0 processes all.")
    parser.add_argument("--order", "--camera-ids", type=int, nargs="*",
                        default=[0, 1, 2, 3, 4, 5, 6],
                        help="Ordering of the cameras provided as a list of ids. "
                             "Example: --order 0 1 4 3 2 5 6.")
    parser.add_argument("--video-2d", action="store_true",
                        help="Generate pose2d videos")
    parser.add_argument("--video-3d", action="store_true",
                        help="Generate pose3d videos")
    parser.add_argument("--skip-pose-estimation", dest="skip_estimation",
                        action="store_true", help="Skip 2D and 3D pose estimation")
    parser.add_argument("--batch-size", type=int, default=8,
                        help="Batch size for inference")
    parser.add_argument("--pin-memory-disabled", action="store_true",
                        help="Accepted for compatibility; batches are always staged "
                             "through pinned host memory on a card.")
    parser.add_argument("--output-fps", type=float, default=None,
                        help="FPS for output videos. Defaults to the input video FPS.")
    parser.add_argument("--solver", choices=["parity", "lm"], default="parity",
                        help="Bundle-adjustment solver: 'parity' replicates the "
                             "reference optimizer; 'lm' is the batched "
                             "Levenberg-Marquardt solver (Huber-robust with "
                             "--ba-huber-px).")
    parser.add_argument("--soft-argmax", action="store_true",
                        help="Sub-pixel heatmap decoding (off = reference-exact argmax)")
    parser.add_argument("--ba-huber-px", type=float, default=0.0,
                        help="Huber scale of the lm solver, in pixels (lm only).")
    parser.add_argument("--checkpoint", default=None,
                        help="Override the hourglass weight file")
    parser.add_argument("--streaming", action="store_true", default=None,
                        help="Run inference straight from camera_{c}.mp4 videos "
                             "(bounded-memory streaming decode, no JPEGs written). "
                             "Default: recordings longer than the config threshold "
                             "(512 frames) stream, short ones are expanded to JPEGs.")
    parser.add_argument("--no-streaming", dest="streaming", action="store_false",
                        help="Force the JPEG expansion flow regardless of length.")
    parser.add_argument("--profile", choices=["fly", "h36m"], default="fly",
                        help="Capture profile: 'fly' (7-camera Drosophila) or "
                             "'h36m' (4-camera 17-joint human, 384x384 network input).")
    parser.add_argument("--calib-prior", default=None,
                        help="Override the calibration-prior pickle "
                             "({cam: {R,tvec,intr,distort}}).")
    parser.add_argument("--device", default="cuda",
                        help="Device of the network: 'cuda' (default; raises without "
                             "a card) or 'cpu' (every kernel's plain version).")
    args = parser.parse_args(argv)
    args.input_folder = Path(args.input_folder).expanduser().resolve()
    if args.output_folder is None:
        args.output_folder = args.input_folder.with_name(
            args.input_folder.stem + "_df3d"
        )
    else:
        args.output_folder = Path(args.output_folder).expanduser().resolve()
    args.input_folder = str(args.input_folder)
    args.output_folder = str(args.output_folder)
    return args


def print_debug(args) -> int:
    level = logging.getLevelName(logger.getLogger().getEffectiveLevel())
    lines = [f"log level: {level}", "parsed arguments:"]
    lines += [f"  {key} = {val}" for key, val in sorted(vars(args).items())]
    print("\n".join(lines))
    return 0


def run_from_file(args) -> int:
    logger.info(f"Reading the folder list from {args.input_folder}")
    try:
        with open(args.input_folder, "r") as f:
            folders = [line.strip() for line in f]
    except FileNotFoundError:
        logger.error(f"No such folder-list file: {args.input_folder}")
        return 1
    except IsADirectoryError:
        logger.error(f"{args.input_folder} is a directory; --from-file expects a text file.")
        return 1

    folders = [f for f in dict.fromkeys(folders) if f.strip()]
    paths = [Path(f) for f in folders]
    bad = [p for p in paths if not p.is_dir()]
    for p in bad:
        logger.error(f"Listed path is not an existing directory: {p}")
    if bad:
        return 1
    logger.info("Will process:\n-" + "\n-".join(folders))
    args.from_file = False
    return run_in_folders(args, paths)


def run_recursive(args) -> int:
    logger.info(f"Scanning `{args.input_folder}` for `images` subfolders")
    subfolders = find_subfolders(args.input_folder, "images")
    logger.info(f"Found {len(subfolders)} subfolders:\n-" + "\n-".join(subfolders))
    args.recursive = False
    return run_in_folders(args, subfolders)


def run_in_folders(args, folders) -> int:
    """Per-folder isolation: collect errors, report at the end."""
    errors = []
    for folder in folders:
        try:
            args.input_folder = str(folder)
            run(args)
        except KeyboardInterrupt:
            logger.warning("Interrupted by the user; stopping the batch.")
            break
        except Exception as e:  # noqa: BLE001 — batch isolation by design
            errors.append((folder, e))
            logger.error(f"Processing failed for {folder}; continuing with the rest.")
    if errors:
        logger.error(f"{len(errors)}/{len(folders)} folders raised errors:")
        for folder, exc in errors:
            logger.error(f"In {folder}", exc_info=exc)
    return 1 if errors else 0


def _solver_kwargs(args) -> dict:
    """Extra bundle-adjustment options from the flags: the lm solver's
    ``huber_px`` (the parity solver takes none)."""
    if args.solver == "lm" and getattr(args, "ba_huber_px", 0.0):
        return {"huber_px": float(args.ba_huber_px)}
    return {}


def run(args) -> int:
    """One recording: setup -> pose2d -> save -> calibrate -> save, then the
    videos; with --skip-pose-estimation, calibrate -> save from the resumed
    2D points, then the videos."""
    from deepfly3d_torch.config import fly_config, h36m_config
    from deepfly3d_torch.core import Core
    from deepfly3d_torch.utils.profiling import StageTimer
    from deepfly3d_torch.viz import video

    if args.skip_estimation and not args.video_2d and not args.video_3d:
        logger.info("Nothing to do. Check your command-line arguments.")
        return 0

    logger.info(f"Working in {args.input_folder}")
    config = h36m_config() if args.profile == "h36m" else None
    if args.calib_prior:
        config = config or fly_config()
        config.calib_prior_path = args.calib_prior
    order = args.order
    if config is not None and order == [0, 1, 2, 3, 4, 5, 6]:
        # the untouched default: one position per camera of the profile
        order = list(range(config.num_cameras))
    timer = StageTimer(device=args.device)
    with timer.stage("setup"):
        core = Core(
            args.input_folder, args.output_folder, args.num_images_max,
            order, config=config, streaming=getattr(args, "streaming", None),
            device=args.device,
        )
    if not args.skip_estimation:
        with timer.stage("pose2d"):
            core.pose2d_estimation(
                args.batch_size,
                disable_pin_memory=args.pin_memory_disabled,
                checkpoint=args.checkpoint,
                soft_argmax=args.soft_argmax,
            )
        core.save()
    with timer.stage("calibrate"):
        core.calibrate_calc(0, core.max_img_id, solver=args.solver, **_solver_kwargs(args))
    with timer.stage("save"):
        core.save()

    fps = args.output_fps if args.output_fps is not None else core.fps
    if args.video_2d:
        with timer.stage("video2d"):
            video.make_pose2d_video(core.plot_2d, core.num_images, core.input_folder,
                                    core.output_folder, fps=fps)
    if args.video_3d:
        with timer.stage("video3d"):
            video.make_pose3d_video(core.get_points3d(), core.plot_2d, core.num_images,
                                    core.input_folder, core.output_folder, fps=fps,
                                    skeleton=core.config.skeleton)
    if args.delete_images:
        core.delete_images()
    # structured per-stage metrics at -v
    logger.info("stage metrics: " + timer.report(frames=core.num_images))
    return 0


def find_subfolders(path, name):
    """Every directory named ``name`` under ``path``; matches are not descended into."""
    top = Path(path)
    if top.is_dir() and top.name == name:
        return [str(top)]
    matches = []
    for root, dirnames, _ in os.walk(path):
        remaining = []
        for d in dirnames:
            if d == name:
                matches.append(os.path.join(root, d))
            else:
                remaining.append(d)
        dirnames[:] = remaining
    return matches


if __name__ == "__main__":
    sys.exit(main())
