"""What used the host's CPUs over a window, from /proc: this process's
CPU seconds, in all and by the name of each thread alive at both ends
(/proc/self/task; threads that a request starts and ends count only in
all), and the machine's busy and stolen seconds (/proc/stat) where its
counters move (a sandbox may show a static /proc/stat).  Printed by each
run beside its result, so a run that reads slow shows whether the server,
the clients or something else held the cores."""

from __future__ import annotations

import os
import resource
from collections import defaultdict

TICK = os.sysconf("SC_CLK_TCK")


def _machine():
    with open("/proc/stat") as f:
        v = [int(x) for x in f.readline().split()[1:]]
    # user nice system idle iowait irq softirq steal
    return {"busy": sum(v[i] for i in (0, 1, 2, 5, 6)), "steal": v[7],
            "idle": v[3] + v[4]}


def _threads():
    by = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                s = f.read()
        except OSError:
            continue
        comm = s[s.index("(") + 1:s.rindex(")")]
        f = s[s.rindex(")") + 2:].split()
        by[tid] = (comm, int(f[11]) + int(f[12]))  # utime, stime
    return by


def _own() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def snapshot():
    try:
        return _machine(), _threads(), _own()
    except (OSError, ValueError, IndexError):
        return None


def report(before, after, clients_cpu_s: float, window_s: float) -> str:
    if before is None or after is None:
        return "host CPU: /proc not readable"
    (m0, t0, own0), (m1, t1, own1) = before, after
    d = {k: (m1[k] - m0[k]) / TICK for k in m0}
    mine = defaultdict(float)
    for tid, (comm, ticks) in t1.items():
        if tid in t0:
            mine[comm] += (ticks - t0[tid][1]) / TICK
    own = own1 - own0
    top = sorted(mine.items(), key=lambda kv: -kv[1])[:6]
    line = (f"host CPU in the window ({window_s:.1f} s, {os.cpu_count()} "
            f"CPUs): this process {own:.1f} s (threads alive throughout, by "
            "name: " + ", ".join(f"{k} {v:.1f}" for k, v in top)
            + f"); clients {clients_cpu_s:.1f} s; ")
    if not any(d.values()):
        return line + "the machine's /proc/stat did not move (use by others "\
            "not visible)"
    return line + (f"machine busy {d['busy']:.1f} s, idle {d['idle']:.1f} "
                   f"s, stolen {d['steal']:.1f} s; everything else "
                   f"{d['busy'] - own - clients_cpu_s:.1f} s")
