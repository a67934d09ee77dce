"""Requests completed without error, over the time from the window's
start to the last such completion."""
UNIT = "req/s"


def read(ctx):
    done = [r.done for r in ctx.records if r.error is None
            and r.done is not None]
    if not done:
        return None
    return len(done) / (max(done) - ctx.t0)
