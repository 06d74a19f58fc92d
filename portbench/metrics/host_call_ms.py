"""Host milliseconds inside the entry call (the program's step, replay or
read), the mean over the untraced window's calls: the harness's own span
around the call, without the feed before it or the wait after it.  (Under
the profiler a replay's host time grows many times: CUPTI's records of
each graph node.)"""


def read(ctx):
    spans = ctx.window.host
    return 1e3 * sum(spans) / len(spans) if spans else None
