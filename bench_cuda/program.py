"""The system under test: ``voicefixer_tpu_torch`` through its public
entries. This module and the entry points (``entries/<entry>.py``) are the
only ones of the benchmark that import the program, and they take from it
only the system itself.

The upstream-layout state dicts go through the program's own loader
(``utils.weights.convert_analysis`` / ``convert_vocoder``, then
``convert_tree``) into ``VoiceFixer(params, vocoder_params)``, and the
configuration's precision is entered with ``ops.precision.precision`` for
the program's whole life. The configuration's ``program`` object holds
``VoiceFixer``'s other keyword arguments (such as ``conv_block_kernel``).
"""

from __future__ import annotations

import contextlib
import dataclasses


def program_config(cfg: dict):
    """The program's ``VoiceFixerConfig`` with every field from ``cfg``; a
    field the file lacks, or one the program lacks, raises."""
    from voicefixer_tpu_torch import config as C
    sections = {"stft": C.STFTConfig, "mel": C.MelConfig,
                "denoiser": C.DenoiserConfig, "unet": C.ResUNetConfig,
                "vocoder": C.VocoderConfig, "pipeline": C.PipelineConfig}
    out = {}
    for name, cls in sections.items():
        fields = {f.name for f in dataclasses.fields(cls)}
        given = set(cfg[name])
        if fields != given:
            raise KeyError(f"config section {name!r}: the program has "
                           f"{sorted(fields - given)} not in the file, the "
                           f"file has {sorted(given - fields)} unknown")
        out[name] = cls(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in cfg[name].items()})
    return C.VoiceFixerConfig(**out)


class Program:
    """``VoiceFixer`` built from host state dicts; ``close`` frees it."""

    def __init__(self, cfg: dict, analysis_sd: dict, vocoder_sd: dict,
                 device):
        from voicefixer_tpu_torch.ops.precision import precision
        from voicefixer_tpu_torch.pipeline.restore import VoiceFixer
        from voicefixer_tpu_torch.utils import weights as W
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(precision(cfg["precision"]))
        params = W.convert_tree(W.convert_analysis(analysis_sd), "analysis",
                                device)
        vparams = W.convert_tree(W.convert_vocoder(vocoder_sd), "vocoder",
                                 device)
        self.vf = VoiceFixer(params, vparams, config=program_config(cfg),
                             device=device, **cfg.get("program", {}))

    def serve(self, entry, waves: list, kwargs: dict) -> list:
        """One request through the entry point ``entry`` (a module of
        ``entries/``): the answers, one a recording."""
        return entry.call(self.vf, waves, kwargs)

    def close(self):
        self.vf = None
        self._stack.close()
