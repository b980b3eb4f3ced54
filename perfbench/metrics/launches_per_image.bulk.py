"""Device activities (kernels, copies, sets) in the traced window per frame
answered: what the compiler's walk issues."""


def read(r):
    images = r.window.counts.get("images")
    if r.trace is None or not images or not r.trace.activities:
        return None
    return r.trace.activities / images
