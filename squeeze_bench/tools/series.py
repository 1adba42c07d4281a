"""Run cells several times in a row, one process at a time, and keep what
each printed.

    python3 squeeze_bench/tools/series.py --out build/series \
        --job qwen2-7b.saturated:11,12,13:51:0 [--job ...] [--smi]

Each ``--job`` is ``workload:seeds:seconds:trace[:control]`` (seeds
comma-separated).  Every run's standard output and error go to
``<out>/<workload>.<seed>.<trace>[.control].{out,err}``; one summary line
per run (exit code, wall seconds, the result line's numbers, the checks)
goes to standard output and to ``<out>/summary.jsonl``.  ``--smi`` adds
the card's name, power limit and clocks before and after.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--job", action="append", required=True)
    ap.add_argument("--smi", action="store_true")
    a = ap.parse_args()
    out = ROOT / a.out
    out.mkdir(parents=True, exist_ok=True)
    summary = open(out / "summary.jsonl", "a")

    def emit(d):
        line = json.dumps(d)
        print(line, flush=True)
        summary.write(line + "\n")
        summary.flush()

    if a.smi:
        emit({"smi": smi()})
    for job in a.job:
        parts = job.split(":")
        wl, seeds, secs, trace = parts[:4]
        control = parts[4] if len(parts) > 4 else None
        for seed in seeds.split(","):
            cmd = [sys.executable, "squeeze_bench/run.py", "--workload", wl,
                   "--seed", seed, "--seconds", secs, "--trace", trace]
            if control:
                cmd += ["--control", control]
            stem = f"{wl}.{seed}.{trace}" + (f".{control}" if control else "")
            t0 = time.perf_counter()
            p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
            dt = time.perf_counter() - t0
            (out / f"{stem}.out").write_text(p.stdout)
            (out / f"{stem}.err").write_text(p.stderr)
            res = None
            lines = p.stdout.strip().splitlines()
            if lines:
                try:
                    res = json.loads(lines[-1])
                except json.JSONDecodeError:
                    res = None
            info = None
            for ln in p.stderr.splitlines():
                if ln.startswith('{"info"'):
                    info = json.loads(ln)["info"]
            emit({"run": stem, "rc": p.returncode, "wall_s": round(dt, 2),
                  "result": res, "info": info,
                  "err_tail": None if res else p.stderr[-1500:]})
    if a.smi:
        emit({"smi": smi()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
