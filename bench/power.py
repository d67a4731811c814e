"""The card's power draw across a window, from one background nvidia-smi.

`nvidia-smi --query-gpu=timestamp,power.draw --format=csv,noheader,nounits
-lms 200` runs as a process of its own (not a thread of the run's
interpreter) on a pseudo-terminal, so each sample is written as it is
taken; a reader thread, which waits on the terminal, keeps the lines. The
samples carry nvidia-smi's own timestamps, so the energy of a window is the
power integrated between its two host-clock ends (wall time, `time.time()`).
"""
from __future__ import annotations

import datetime
import os
import pty
import subprocess
import threading
import time

PERIOD_MS = 200


def _parse(line: str):
    """(unix seconds, watts) of one sample line, or None."""
    try:
        stamp, watts = (x.strip() for x in line.split(","))
        when = datetime.datetime.strptime(stamp, "%Y/%m/%d %H:%M:%S.%f").timestamp()
        return when, float(watts)
    except ValueError:
        return None


class PowerSampler:
    """Samples one card (`card`: nvidia-smi's -i, its UUID or index) every
    PERIOD_MS until `stop`."""

    def __init__(self, card: str):
        self.samples: list[tuple[float, float]] = []
        self.lines: list[str] = []
        master, slave = pty.openpty()
        self._master = master
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", card, "--query-gpu=timestamp,power.draw",
             "--format=csv,noheader,nounits", "-lms", str(PERIOD_MS)],
            stdout=slave, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL, close_fds=True)
        os.close(slave)
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()

    def _read(self) -> None:
        buf = b""
        while True:
            try:
                chunk = os.read(self._master, 4096)
            except OSError:  # the terminal closed: the process ended
                break
            if not chunk:
                break
            buf += chunk
            *done, buf = buf.split(b"\n")
            for raw in done:
                line = raw.decode(errors="replace").strip()
                self.lines.append(line)
                sample = _parse(line)
                if sample is not None:
                    self.samples.append(sample)

    def wait_for(self, when: float, timeout: float = 10.0) -> None:
        """Wait until a sample taken after wall time `when` has arrived."""
        deadline = time.monotonic() + timeout
        while not (self.samples and self.samples[-1][0] > when):
            if time.monotonic() > deadline or self.proc.poll() is not None:
                raise RuntimeError("nvidia-smi gave no power sample: "
                                   + " | ".join(self.lines[-3:]))
            time.sleep(0.02)

    def stop(self) -> None:
        """End the process and wait for it and the reader."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._thread.join(timeout=5)
        os.close(self._master)

    def energy_j(self, a: float, b: float) -> float:
        """Joules between wall times a and b: the samples' piecewise-linear
        power, integrated; it needs a sample at or before a and one at or
        after b."""
        pts = sorted(self.samples)
        if not pts or pts[0][0] > a or pts[-1][0] < b:
            raise RuntimeError(f"power samples cover {pts[0][0] if pts else None}.."
                               f"{pts[-1][0] if pts else None}, not the window {a}..{b}")

        def at(t: float) -> float:
            for (t0, p0), (t1, p1) in zip(pts, pts[1:]):
                if t0 <= t <= t1:
                    return p0 if t1 == t0 else p0 + (p1 - p0) * (t - t0) / (t1 - t0)
            return pts[-1][1]

        inner = [(t, p) for t, p in pts if a < t < b]
        knots = [(a, at(a))] + inner + [(b, at(b))]
        return sum((t1 - t0) * (p0 + p1) / 2 for (t0, p0), (t1, p1) in zip(knots, knots[1:]))

    def mean_w(self, a: float, b: float) -> float:
        return self.energy_j(a, b) / (b - a)
