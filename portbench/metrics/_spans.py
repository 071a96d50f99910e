"""Self time of the program's spans over a traced run's window.

A span's self time is its duration less the time its children cover:
the spans whose `parent` is its `id` (the program's recorder nests a
thread's spans, so children never overlap). Each is clipped to the
window first, so the self times of every span under a root sum to the
root's time in the window."""


def self_share(run, names):
    """Σ self time of the spans named in `names`, clipped to the
    window, over the window's length; None when no such span was
    recorded (a program without these spans)."""
    w0, w1 = run.t_window0 * 1e9, run.t_window1 * 1e9
    spans = [s for s in run.spans if s.get("ph") == "X"]

    def clipped(s):
        return max(min(s["ts"] + s["dur"], w1) - max(s["ts"], w0), 0)

    covered = {}
    for s in spans:
        p = s.get("parent")
        if p is not None:
            covered[p] = covered.get(p, 0) + clipped(s)
    total = 0
    seen = False
    for s in spans:
        if s.get("name") in names:
            seen = True
            total += clipped(s) - covered.get(s.get("id"), 0)
    if not seen or w1 <= w0:
        return None
    return total / (w1 - w0)
