"""The share of the window the host spent waiting on the card: the
program's `host_sync` spans, clipped to the window, summed over its
length."""


def read(run):
    w0, w1 = run.t_window0 * 1e9, run.t_window1 * 1e9
    busy = 0.0
    seen = False
    for s in run.spans:
        if s.get("name") != "host_sync" or s.get("ph") != "X":
            continue
        seen = True
        a, b = max(s["ts"], w0), min(s["ts"] + s["dur"], w1)
        busy += max(b - a, 0)
    if not seen or w1 <= w0:
        return None
    return busy / (w1 - w0)
