"""
The traced window, read from ``torch.profiler``'s Chrome trace: each
call's host span (the harness's ``bench.call`` annotation) with the device
operations that started inside it, the device's busy time, and the host's
activity in the device's idle gaps.

Device operations are the trace's kernels, copies and memsets.  A call
ends in a synchronize (or in its result's download), so every device
operation of call i starts inside its host span.
"""

import bisect
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
CALL = "bench.call"
WINDOW = "bench.window"


def _union(intervals):
    """Merged (start, end) pairs of ``intervals``, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Summary:
    """What the per-layer metrics read: ``calls`` (a dict a call: its
    host ``wall_s``, its kernels' ``kernel_s``, its ``device_ops``
    count), ``window_s``, ``busy_s``, and the ``breakdown``."""

    def __init__(self, events):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        window = [e for e in xs if e.get("name") == WINDOW
                  and e.get("cat") == "user_annotation"]
        if not window:
            raise ValueError("the trace holds no window annotation")
        w0 = float(window[0]["ts"])
        w1 = w0 + float(window[0]["dur"])
        self.window_s = (w1 - w0) * 1e-6
        dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e.get("cat"), e.get("name", ""))
                     for e in xs if e.get("cat") in DEVICE_CATS
                     and w0 <= float(e["ts"]) < w1)
        calls = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in xs if e.get("name") == CALL
                       and e.get("cat") == "user_annotation")
        self.calls = [dict(wall_s=(e - s) * 1e-6, kernel_s=0.0, device_ops=0)
                      for s, e in calls]
        starts = [s for s, _ in calls]
        for s, e, cat, _ in dev:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s <= calls[i][1]:
                self.calls[i]["device_ops"] += 1
                if cat == "kernel":
                    self.calls[i]["kernel_s"] += (e - s) * 1e-6
        busy = _union([(max(s, w0), min(e, w1)) for s, e, _, _ in dev])
        self.busy_s = sum(e - s for s, e in busy) * 1e-6
        self.device_ops = len(dev)

        by_name = {}
        for s, e, _, name in dev:
            by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                       e.get("name", ""))
                      for e in xs if e.get("cat") in HOST_CATS
                      and e.get("name") not in (WINDOW,))
        gaps = []
        edges = [w0] + [v for s, e in busy for v in (s, e)] + [w1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append((a, b))
        idle = {}
        host_starts = [h[0] for h in host]
        for a, b in gaps:
            mid = 0.5 * (a + b)
            # the innermost host span that holds the gap's middle
            best = None
            j = bisect.bisect_right(host_starts, mid)
            for h in host[max(0, j - 256):j]:
                if h[1] >= mid and (best is None or h[1] - h[0]
                                    < best[1] - best[0]):
                    best = h
            i = bisect.bisect_right(starts, mid) - 1
            in_call = i >= 0 and mid <= calls[i][1]
            name = (best[2] if best else CALL if in_call
                    else "between calls")
            idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
        self.breakdown = dict(
            device_ops=[[n, s] for n, s in top],
            idle_gaps=[[n, s] for n, s in sorted(
                idle.items(), key=lambda kv: -kv[1])[:10]])


def read(path):
    with open(path) as f:
        data = json.load(f)
    return Summary(data["traceEvents"] if isinstance(data, dict) else data)
