"""The share of the untraced window in which no operation ran on the device:
one minus the device's busy time a call (the union of its operations over
the traced calls, by the calls) over the untraced window's time a call.

The idle share of the traced window itself is no measure of the program:
under the profiler the host's launch of a replayed graph takes milliseconds
(CUPTI records each of its nodes), and the device waits for it.  The busy
time a call comes from the trace, the only record of the device's
operations; the profiler lengthens them a little too, so a cell whose
device never idles reads just under 0 (the full tuner: the traced calls'
device time 1.5% over the untraced calls' whole time on an H100)."""


def read(ctx):
    if ctx.trace.busy_s <= 0 or ctx.window.calls == 0 or ctx.window.seconds <= 0:
        return None
    busy = ctx.trace.busy_s / ctx.calls
    return 1.0 - busy * ctx.window.calls / ctx.window.seconds
