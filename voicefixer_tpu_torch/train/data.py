"""Paired training audio, as ``voicefixer_tpu/train/data.py``: random
fixed-length crops of (degraded, clean) pairs matched by file name across
two folders, batched into numpy arrays by a background prefetch thread. The
crops come from a numpy generator in the same order as there, so a seed
gives the JAX package's batches."""

from __future__ import annotations

import os
import queue
import threading

import numpy as np

from voicefixer_tpu_torch.utils import audio_io

AUDIO_EXTS = (".wav", ".flac")


def list_audio_files(folder: str) -> list:
    return sorted(
        os.path.join(folder, f) for f in os.listdir(folder)
        if os.path.splitext(f)[-1].lower() in AUDIO_EXTS)


def random_chunk(wav: np.ndarray, chunk: int, rng: np.random.Generator
                 ) -> np.ndarray:
    """A random crop of ``chunk`` samples, zero-padded where the clip is
    shorter."""
    if wav.shape[0] <= chunk:
        out = np.zeros(chunk, dtype=np.float32)
        out[:wav.shape[0]] = wav
        return out
    start = int(rng.integers(0, wav.shape[0] - chunk))
    return wav[start:start + chunk]


class PairedDataset:
    """(degraded, clean) pairs matched by file name. Without
    ``degraded_dir`` the clean crop is returned twice (make the degraded
    side with ``train.augment.add_noise_and_scale``)."""

    def __init__(self, clean_dir: str, degraded_dir: str | None = None,
                 sample_rate: int = 44100, chunk_seconds: float = 3.0,
                 seed: int = 0):
        self.clean_files = list_audio_files(clean_dir)
        if not self.clean_files:
            raise ValueError(f"no audio files in {clean_dir}")
        self.degraded_files = None
        if degraded_dir is not None:
            self.degraded_files = {
                os.path.basename(f): f
                for f in list_audio_files(degraded_dir)}
            missing = [f for f in self.clean_files
                       if os.path.basename(f) not in self.degraded_files]
            if missing:
                raise ValueError(
                    f"{len(missing)} clean files missing degraded pairs, "
                    f"e.g. {os.path.basename(missing[0])}")
        self.sample_rate = sample_rate
        self.chunk = int(sample_rate * chunk_seconds)
        self.rng = np.random.default_rng(seed)

    @staticmethod
    def _crop(wav: np.ndarray, start: int, chunk: int) -> np.ndarray:
        out = np.zeros(chunk, dtype=np.float32)
        seg = wav[start: start + chunk]
        out[: seg.shape[0]] = seg
        return out

    def sample_pair(self):
        """-> (degraded [chunk], clean [chunk]) float32, cropped at the same
        place so that the pair stays aligned."""
        f = self.clean_files[int(self.rng.integers(len(self.clean_files)))]
        clean = audio_io.load_wav(f, self.sample_rate)
        max_start = max(0, clean.shape[0] - self.chunk)
        start = int(self.rng.integers(0, max_start + 1))
        clean_c = self._crop(clean, start, self.chunk)
        if self.degraded_files is None:
            return clean_c, clean_c
        g = self.degraded_files[os.path.basename(f)]
        degraded = audio_io.load_wav(g, self.sample_rate)
        return self._crop(degraded, start, self.chunk), clean_c

    def batches(self, batch_size: int, prefetch: int = 2):
        """Endless iterator of (degraded [B, N], clean [B, N]), filled by a
        background thread that stops when the iterator is closed."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                pairs = [self.sample_pair() for _ in range(batch_size)]
                item = (np.stack([p[0] for p in pairs]),
                        np.stack([p[1] for p in pairs]))
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        pass

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
            t.join()
