"""Seconds of input audio whose requests completed in the window, over the
window's seconds (the window closes at the end of the first call that ends
past --seconds, so every request sent completed inside it)."""


def read(run):
    return run.audio_s / run.window_s if run.window_s > 0 else None
