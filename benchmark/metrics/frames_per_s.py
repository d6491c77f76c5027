"""frames_per_s: the frames of every request completed in the window over
the window's seconds (the window closes when the last request sent before
its end completes)."""


def read(run):
    w = run.window
    if w is None or not w.latencies_s:
        return None
    return w.frames / w.window_s
