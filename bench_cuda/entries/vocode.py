"""``BigVGAN.synthesize``: each log-mel of a request ([frames, num_mels]) in,
its wave ([frames * hop]) out, one call each. The family's reference judges
it whole (``families/bigvgan.py``'s ``compare``); it takes no keyword
arguments."""


def validate(kwargs: dict):
    if kwargs:
        raise ValueError(f"vocode takes no keyword arguments: {kwargs}")


def call(system, mels: list, kwargs: dict) -> list:
    return [system.synthesize(m)[0] for m in mels]
