"""audio_s_per_s: seconds of input audio restored per wall second, over
every request of the window (which ends with the last request that
started in it). Host clock."""


def read(run):
    if not run.window:
        return None
    audio = sum(r.audio_s for r in run.window if r.ok)
    return audio / (run.window_end - run.window_start)
