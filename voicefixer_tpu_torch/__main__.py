"""Command line of the port, with the flags of ``voicefixer_tpu/__main__.py``
(upstream's surface):

    python -m voicefixer_tpu_torch -i in.wav -o out.flac --mode {0,1,2,all}
    python -m voicefixer_tpu_torch -ifdr folder -ofdr outfolder

It runs on the CUDA card, and raises where there is none, unless
``--disable-cuda`` asks for the CPU (the plain PyTorch versions). WAV,
FLAC, AIFF and AU are read; WAV and FLAC are written (int16). ``--mode
all`` writes one file a mode, ``<base>-mode{k}<ext>``; ``--seed`` seeds
mode 2's dropout. In a folder, modes 0 and 1 without ``--chunk-overlap``
restore every chunk of every file in batches of equal lengths
(``parallel.inference.restore_wavs``, at most ``ROWS_PER_CARD`` chunks a
batch on a card), unless VF_NO_DP is set; mode 2 and overlap-add go file by
file.

Several processes, one per card (``parallel.distributed``):

    python -m voicefixer_tpu_torch -ifdr in -ofdr out \
        --coordinator host:port --num-processes N --process-id K

or VF_COORDINATOR / VF_NUM_PROCESSES / VF_PROCESS_ID. Process K drives
``cuda:{K % device_count}`` on NCCL (gloo with ``--disable-cuda``). A
folder's files are shared round-robin, ``files[K::N]``, and each process
writes only its own; a single file is restored and written by process 0.
Only process 0 prints "Done", after every process has finished. A process
id outside [0, N), or a count or id without a coordinator, raises before
anything is written.

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
# chunks a card restores at once in folder mode (restore_wavs' max_batch):
# the peak device memory of a full-width 30 s chunk row, measured by
# chip_smoke.py, bounds it on an 80 GB card (PERF.md)
ROWS_PER_CARD = 16


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
                        help="Multi-process runs: host:port of process 0 "
                             "(or a tcp:// or file:// URL, or 'auto' for "
                             "a launcher's env://); env VF_COORDINATOR")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="Multi-process runs: the number of processes, "
                             "one per card; env VF_NUM_PROCESSES")
    parser.add_argument("--process-id", type=int, default=None,
                        help="Multi-process runs: this process's rank; env "
                             "VF_PROCESS_ID")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = "cpu" if args.disable_cuda else None
    from voicefixer_tpu_torch.parallel import distributed
    distributed.initialize(args.coordinator, args.num_processes,
                           args.process_id, device=device)
    try:
        return _run(args, device, distributed.process_index(),
                    distributed.process_count())
    finally:
        distributed.shutdown()


def _run(args, device, pid: int, n_proc: int) -> int:
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
    if not args.silent and pid == 0:
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
        if pid == 0:  # one unit of work: process 0 restores and writes it
            if not args.silent:
                print(f"Start processing the input file {args.infile}.")
            for m in modes:
                writefile(voicefixer, args.infile, args.outfile, m, append,
                          args.seed, verbose=not args.silent,
                          chunk_overlap=args.chunk_overlap)

    if process_folder:
        files = [f for f in sorted(os.listdir(args.infolder))
                 if os.path.splitext(f)[-1].lower() in AUDIO_EXTS]
        if not args.silent and pid == 0:
            print(f"Found {len(files)} audio files in the input folder "
                  f"{args.infolder}. Start processing.")
        my_files = files[pid::n_proc]
        dp_modes = [m for m in modes if int(m) in (0, 1)
                    and args.chunk_overlap == 0 and my_files
                    and not os.environ.get("VF_NO_DP")]
        if dp_modes:
            _restore_folder_batched(voicefixer, args, my_files, dp_modes,
                                    append, pid, n_proc)
        for f in my_files:
            out_file = os.path.join(args.outfolder,
                                    os.path.splitext(f)[0] + ".wav")
            for m in modes:
                if m not in dp_modes:
                    writefile(voicefixer, os.path.join(args.infolder, f),
                              out_file, m, append, args.seed,
                              verbose=not args.silent,
                              chunk_overlap=args.chunk_overlap)

    from voicefixer_tpu_torch.parallel import distributed
    distributed.barrier()
    if not args.silent and pid == 0:
        print("Done")
    return 0


def _restore_folder_batched(voicefixer, args, files: list, modes: list,
                            append: bool, pid: int, n_proc: int):
    """Modes 0 and 1 of this process's files through ``restore_wavs`` on
    its own card: every chunk of every file, batched by length."""
    from voicefixer_tpu_torch.parallel.inference import restore_wavs
    from voicefixer_tpu_torch.utils import audio_io
    sr = voicefixer.config.pipeline.sample_rate
    wavs = [audio_io.load_wav(os.path.join(args.infolder, f), sr)
            for f in files]
    for m in modes:
        start = time.time()
        outs = restore_wavs(voicefixer, wavs, mode=int(m),
                            max_batch=ROWS_PER_CARD)
        for f, out in zip(files, outs):
            dst = os.path.join(args.outfolder, os.path.splitext(f)[0]
                               + ".wav")
            if append:
                base, ext = os.path.splitext(os.path.basename(dst))
                dst = os.path.join(os.path.dirname(dst),
                                   f"{base}-mode{m}{ext}")
            audio_io.save_wave(out, fname=dst, sample_rate=sr)
        if not args.silent:
            print(f"Restoration took {round(time.time() - start, 1)} s "
                  f"({len(files)} files, mode {m}, process {pid}/{n_proc})")


if __name__ == "__main__":
    sys.exit(main())
