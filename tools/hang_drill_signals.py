"""Run chip_smoke.py's hang drill and record every SIGHUP and SIGCONT
this process receives, with the process groups and sessions around it.

    python3 tools/hang_drill_signals.py [--tree DIR] [--runs N] [--prelude]

``--tree`` is the checkout whose ``chip_smoke.py`` (and package) to run
(default: this one; another one unpacked by ``git archive`` under
``build/``, say).  ``--prelude`` first runs a world of 4 ranks through
``spawn_world`` on the card, as phase 4c does before the drill.  A SIGHUP
does not end this process: it is printed with the time and a snapshot of
the processes of this session (``ps``: pid, parent, group, session,
state), and so is a SIGCONT.  The kernel sends SIGHUP and then SIGCONT to
every member of a process group that becomes orphaned while one of its
members is stopped; a SIGHUP with a SIGCONT right behind it is that.  A
thread also snapshots the session whenever a process of it is stopped.
Each rank prints its pid, parent, group and session to its log, and the
logs of the last run are printed at the end.  Needs the card.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

T0 = time.monotonic()


def now() -> str:
    return f"{time.monotonic() - T0:8.2f}s"


def session_ps() -> str:
    out = subprocess.run(["ps", "-eo", "pid,ppid,pgid,sid,stat,args"],
                         capture_output=True, text=True).stdout.splitlines()
    sid = os.getsid(0)
    keep = [out[0]] + [ln for ln in out[1:]
                       if len(ln.split()) > 3 and ln.split()[3] == str(sid)
                       or "supervisor" in ln]
    return "\n".join(ln[:160] for ln in keep)


def on_signal(signum, _frame):
    print(f"[{now()}] pid {os.getpid()} got {signal.Signals(signum).name}\n"
          f"{session_ps()}", flush=True)


def watch_stopped(stop: threading.Event) -> None:
    seen = set()
    while not stop.wait(1.0):
        rows = subprocess.run(["ps", "-eo", "pid,stat"], capture_output=True,
                              text=True).stdout.split("\n")[1:]
        stopped = {r.split()[0] for r in rows if len(r.split()) == 2
                   and r.split()[1].startswith("T")}
        if stopped - seen:
            print(f"[{now()}] stopped now: {sorted(stopped)}\n{session_ps()}",
                  flush=True)
        seen = stopped


def _noop(mesh):
    return mesh.rank


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--prelude", action="store_true")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import chip_smoke as cs   # puts the tree's src/ first on the path

    print(f"[{now()}] drill process pid {os.getpid()} ppid {os.getppid()} pgid "
          f"{os.getpgid(0)} sid {os.getsid(0)} tree {tree}\n{session_ps()}",
          flush=True)
    signal.signal(signal.SIGHUP, on_signal)
    signal.signal(signal.SIGCONT, on_signal)
    stop = threading.Event()
    threading.Thread(target=watch_stopped, args=(stop,), daemon=True).start()
    if args.prelude:
        got = cs.spawn_world(_noop, 4, device="cuda", timeout_s=120)
        print(f"[{now()}] prelude spawn_world of 4: {got}", flush=True)
    cs._build.build(("p2p", "m2l"))
    m_side = int(round(cs.CONFIG.num_particles ** 0.5))
    root = tree / "build"
    root.mkdir(exist_ok=True)
    ok = True
    for run in range(args.runs):
        work = Path(tempfile.mkdtemp(prefix="hangsig_", dir=root))
        t = time.perf_counter()
        try:
            _, result, _, _, _ = cs.drill_run(str(work / "hang"), m_side, cs.CONFIG.p,
                                              cs.DRILL_HANG, "proc_hang")
            print(f"[{now()}] run {run}: ranks {result.ranks} step "
                  f"{result.final_step} detect {result.faults[0].detect_seconds:.2f} s "
                  f"in {time.perf_counter() - t:.1f} s", flush=True)
        except Exception as e:   # keep the logs of a failed drill too
            ok = False
            print(f"[{now()}] run {run} failed: {e!r}", flush=True)
        for log in sorted(work.rglob("worker_*.log")):
            head = [ln for ln in log.read_text(errors="replace").splitlines()
                    if "pgid" in ln or "Error" in ln or "Signal" in ln]
            print(f"--- {log.relative_to(work)}: {head[:4]}", flush=True)
    stop.set()
    print(f"[{now()}] done ok={ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
