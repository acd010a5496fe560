"""What the host was doing around the window: lines for attribution,
never for the result.

Each run logs the CPUs it may use and those local to the card (from
nvidia-smi's bus id and sysfs), a fixed single-thread probe before and
after the window, the load average, the process's CPU seconds so far
(their rise over the window against its length says whether a slow
run did its work more slowly or waited), and the card's clocks and
power. The studies in PERF.md (section 6) tried pinning to the card's
CPUs, fixed thread counts, inputs flushed in set-up, the collector run
and frozen before the window, glibc keeping freed memory, a shorter
interpreter switch interval, a longer warm-up and outputs held once;
none narrowed the spread of the runs, so none is applied.
"""

from __future__ import annotations

import os
import subprocess
import time


def _smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, timeout=30)
    return out.stdout.strip()


def _cpulist(text: str) -> set:
    cpus = set()
    for part in text.strip().split(","):
        if not part:
            continue
        a, _, b = part.partition("-")
        cpus.update(range(int(a), int(b or a) + 1))
    return cpus


def _nvidia_functions() -> list:
    """The sysfs ids of NVIDIA display and 3D controllers."""
    out = []
    base = "/sys/bus/pci/devices"
    for dev in sorted(os.listdir(base)) if os.path.isdir(base) else []:
        try:
            with open(os.path.join(base, dev, "vendor")) as f:
                vendor = f.read().strip()
            with open(os.path.join(base, dev, "class")) as f:
                cls = f.read().strip()
        except OSError:
            continue
        if vendor == "0x10de" and cls[:6] in ("0x0300", "0x0302"):
            out.append(dev)
    return out


def card_bus_id():
    """(sysfs id of card 0, how it was found) or (None, why not)."""
    try:
        bus = _smi("pci.bus_id").splitlines()[0]
        dom, _, rest = bus.partition(":")
        return f"{int(dom, 16):04x}:{rest}".lower(), "nvidia-smi"
    except (OSError, subprocess.SubprocessError, IndexError, ValueError) \
            as e:
        why = f"nvidia-smi gave no bus id ({e!r})"
    found = _nvidia_functions()
    if len(found) == 1:
        return found[0], why + "; the one NVIDIA function in sysfs"
    return None, why + f"; NVIDIA functions in sysfs: {found}"


def card_local_cpus():
    """(cpus, note): the allowed CPUs local to card 0, or (None, why)."""
    allowed = os.sched_getaffinity(0)
    sysid, how = card_bus_id()
    if sysid is None:
        return None, how
    try:
        with open(f"/sys/bus/pci/devices/{sysid}/local_cpulist") as f:
            local = _cpulist(f.read())
    except OSError as e:
        return None, f"no local_cpulist for {sysid} ({e!r})"
    both = local & allowed
    if not both:
        return None, (f"card {sysid} is local to {sorted(local)}, none of "
                      f"them allowed ({sorted(allowed)})")
    return both, f"card {sysid} ({how}), local {sorted(local)}"


def cpu_line() -> str:
    allowed = sorted(os.sched_getaffinity(0))
    cpus, note = card_local_cpus()
    local = "not found" if cpus is None else sorted(cpus)
    return f"CPUs: allowed {allowed}; local to the card {local} ({note})"


def cpu_probe_ms() -> float:
    """A fixed single-thread integer loop, in ms: the host's speed for
    one Python thread at this moment."""
    t0 = time.perf_counter()
    x = 0
    for i in range(500_000):
        x = (x * 31 + i) & 0xFFFFFFFF
    return (time.perf_counter() - t0) * 1e3


def card_state() -> str:
    try:
        return _smi("clocks.sm,clocks.mem,power.draw,power.limit,"
                    "temperature.gpu")
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e!r})"


def host_line(tag: str) -> str:
    la = os.getloadavg()
    cpu = os.times()
    return (f"host {tag}: probe {cpu_probe_ms():.3f} ms, loadavg "
            f"{la[0]:.2f} {la[1]:.2f} {la[2]:.2f}; process CPU "
            f"{cpu.user + cpu.system:.2f} s; card "
            f"(sm MHz, mem MHz, W, limit, C) {card_state()}")
