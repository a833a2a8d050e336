"""Command line of the port, with the flags of ``voicefixer_tpu/__main__.py``
(upstream's surface):

    python -m voicefixer_tpu_torch -i in.wav -o out.flac --mode {0,1,2,all}
    python -m voicefixer_tpu_torch -ifdr folder -ofdr outfolder

It runs on the CUDA card, and raises where there is none, unless
``--disable-cuda`` asks for the CPU (the plain PyTorch versions). WAV,
FLAC, AIFF and AU are read; WAV and FLAC are written (int16). A folder is
restored file by file. ``--mode all`` writes one file a mode,
``<base>-mode{k}<ext>``; ``--seed`` seeds mode 2's dropout.

Not ported yet, and raising ``NotImplementedError`` before any file is
written: the multi-process flags ``--coordinator``, ``--num-processes`` and
``--process-id`` or their VF_* variables (ROADMAP.md Queue 1 item 8).
Nothing is downloaded:
``--weight_prepare`` converts the local checkpoints (the npz cache, or the
reference's torch cache into it) and builds the CUDA kernels unless
VF_SKIP_PREWARM is set.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

AUDIO_EXTS = (".wav", ".flac")
_MULTI_PROCESS = (("coordinator", "VF_COORDINATOR"),
                  ("num_processes", "VF_NUM_PROCESSES"),
                  ("process_id", "VF_PROCESS_ID"))


def writefile(voicefixer, infile: str, outfile: str, mode, append_mode: bool,
              seed: int, verbose: bool = False, chunk_overlap: float = 0.0):
    """Restore one file; with ``append_mode`` (``--mode all``) to
    ``<base>-mode{mode}<ext>``."""
    if append_mode:
        base, ext = os.path.splitext(os.path.basename(outfile))
        outfile = os.path.join(os.path.dirname(outfile),
                               f"{base}-mode{mode}{ext}")
    if verbose:
        print(f"Processing {infile}, mode={mode}")
    start = time.time()
    voicefixer.restore(input=infile, output=outfile, mode=int(mode),
                       seed=seed, chunk_overlap_seconds=chunk_overlap)
    print(f"Restoration took {round(time.time() - start, 1)} s")


def check_output_format(outfile: str):
    ext = os.path.splitext(outfile)[-1]
    if not ext:
        raise SystemExit("Error: A file-extension for the outfile is "
                         "missing.")
    if ext.lower() not in AUDIO_EXTS:
        raise SystemExit(f"Error: Unsupported output format {ext} — this "
                         "build writes WAV (scipy) and FLAC (bundled "
                         "encoder) containers.")


def check_arguments(args):
    process_file = len(args.infile) != 0
    process_folder = len(args.infolder) != 0
    if not (process_file or process_folder):
        raise SystemExit(
            "Error: You need to specify an input file path (--infile) or an "
            "input folder path (--infolder) to proceed. For more information "
            "please run: python -m voicefixer_tpu_torch -h")
    if process_file:
        if not os.path.exists(args.infile):
            raise SystemExit(f"Error: The input file {args.infile} is not "
                             "found.")
        output_dirname = os.path.dirname(args.outfile)
        if len(output_dirname) > 1:
            os.makedirs(output_dirname, exist_ok=True)
        check_output_format(args.outfile)
    if process_folder:
        if not os.path.exists(args.infolder):
            raise SystemExit(f"Error: The input folder {args.infolder} is "
                             "not found.")
        if len(args.outfolder) > 1:
            os.makedirs(args.outfolder, exist_ok=True)
    return process_file, process_folder


def check_unported(args):
    """Raise for what the port does not do yet, before anything is
    written."""
    for flag, env in _MULTI_PROCESS:
        if getattr(args, flag) is not None or os.environ.get(env):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} / ${env}: multi-process runs "
                "are not ported yet: ROADMAP.md Queue 1 item 8")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="voicefixer_tpu_torch",
        description="VoiceFixer (PyTorch and CUDA port) — restores degraded "
                    "speech")
    parser.add_argument("-i", "--infile", type=str, default="",
                        help="An input file to be processed.")
    parser.add_argument("-o", "--outfile", type=str, default="outfile.wav",
                        help="An output file to store the result.")
    parser.add_argument("-ifdr", "--infolder", type=str, default="",
                        help="Input folder of wav/flac files to process.")
    parser.add_argument("-ofdr", "--outfolder", type=str, default="outfolder",
                        help="Output folder for processed files.")
    parser.add_argument("--mode", choices=["0", "1", "2", "all"], default="0",
                        help="0: original model (default), 1: add "
                             "preprocessing (remove higher frequencies), "
                             "2: train mode (batch-stats BN + dropout), "
                             "all: one output file per mode.")
    parser.add_argument("--disable-cuda", default=False, action="store_true",
                        help="Run on the CPU (the plain PyTorch versions). "
                             "Without it the run needs a CUDA card.")
    parser.add_argument("--silent", default=False, action="store_true",
                        help="Suppress progress messages.")
    parser.add_argument("--weight_prepare", default=False,
                        action="store_true",
                        help="Only convert the local checkpoints (into the "
                             "npz cache) and build the CUDA kernels, then "
                             "exit. Nothing is downloaded.")
    parser.add_argument("--chunk-overlap", type=float, default=0.0,
                        help="Seconds of overlap between 30 s chunks; > 0 "
                             "stitches long files by crossfaded overlap-add. "
                             "Default 0: upstream's hard seams.")
    parser.add_argument("--seed", type=int, default=0,
                        help="Seed of mode 2's dropout (deterministic, "
                             "unlike upstream's).")
    parser.add_argument("--ckpt", type=str, default=None,
                        help="Analysis checkpoint path (npz or torch vf.ckpt)")
    parser.add_argument("--vocoder-ckpt", type=str, default=None,
                        help="Vocoder checkpoint path (npz or torch .pt)")
    parser.add_argument("--config-preset", choices=["production", "tiny"],
                        default="production",
                        help="'tiny' selects the scaled-down test config "
                             "(needs matching --ckpt/--vocoder-ckpt npz "
                             "params)")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="Multi-process runs: not ported yet.")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="Multi-process runs: not ported yet.")
    parser.add_argument("--process-id", type=int, default=None,
                        help="Multi-process runs: not ported yet.")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    check_unported(args)
    device = "cpu" if args.disable_cuda else None

    if args.weight_prepare:
        from voicefixer_tpu_torch.pipeline import checkpoints
        checkpoints.load_analysis_params(args.ckpt)
        checkpoints.load_vocoder_params(args.vocoder_ckpt)
        if not os.environ.get("VF_SKIP_PREWARM"):
            from voicefixer_tpu_torch.kernels import build
            if not args.silent:
                print("Building the CUDA kernels")
            build.build_all()
        return 0

    process_file, process_folder = check_arguments(args)
    if not args.silent:
        print("Initializing VoiceFixer")
    from voicefixer_tpu_torch.config import DEFAULT_CONFIG, tiny_test_config
    from voicefixer_tpu_torch.pipeline.restore import VoiceFixer
    config = tiny_test_config() if args.config_preset == "tiny" \
        else DEFAULT_CONFIG
    voicefixer = VoiceFixer(ckpt=args.ckpt, vocoder_ckpt=args.vocoder_ckpt,
                            config=config, device=device)
    modes = range(3) if args.mode == "all" else [args.mode]
    append = args.mode == "all"

    if process_file:
        audioext = os.path.splitext(os.path.basename(args.infile))[-1]
        if audioext.lower() not in AUDIO_EXTS:
            raise SystemExit(
                f"Error: unsupported input format {audioext}; supported: "
                f"{', '.join(AUDIO_EXTS)}.")
        if not args.silent:
            print(f"Start processing the input file {args.infile}.")
        for m in modes:
            writefile(voicefixer, args.infile, args.outfile, m, append,
                      args.seed, verbose=not args.silent,
                      chunk_overlap=args.chunk_overlap)

    if process_folder:
        files = [f for f in sorted(os.listdir(args.infolder))
                 if os.path.splitext(f)[-1].lower() in AUDIO_EXTS]
        if not args.silent:
            print(f"Found {len(files)} audio files in the input folder "
                  f"{args.infolder}. Start processing.")
        for f in files:
            out_file = os.path.join(args.outfolder,
                                    os.path.splitext(f)[0] + ".wav")
            for m in modes:
                writefile(voicefixer, os.path.join(args.infolder, f),
                          out_file, m, append, args.seed,
                          verbose=not args.silent,
                          chunk_overlap=args.chunk_overlap)

    if not args.silent:
        print("Done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
