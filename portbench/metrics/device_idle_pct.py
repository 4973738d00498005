"""The device's idle share of a replayed cycle, in %, from the trace:
1 - busy / wall over the profiled cycles (plain ones back to back, and
the refresh cycle alone), mixed as a refresh period mixes them. Busy
is the sum of the device operations' durations (kernels, copies,
memsets; one stream, so they do not overlap), wall the host clock from
a synchronize before the replays to one after them."""


def read(facts):
    spans = facts.spans
    if "plain" not in spans or "refresh" not in spans:
        return None
    k = facts.layout.filter_every
    plain, ref = spans["plain"], spans["refresh"]
    n = facts.plain_cycles
    busy = (k - 1) * plain.busy_s / n + ref.busy_s
    wall = (k - 1) * plain.wall_s / n + ref.wall_s
    return 100.0 * (1.0 - busy / wall)
