"""Device operations in the profiled slice per second of audio decoded."""


def read(s):
    audio = s.work.get("audio_s")
    return len(s.kernels) / audio if audio and s.kernels else None
