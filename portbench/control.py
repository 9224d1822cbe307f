"""Read a cell's compared numbers for the program and for its controls,
seed after seed in one process, on the chip:

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 3 --controls stale,bf16

Each seed makes the cell's set-up and a short window at its own load, as
a run does; then the program's sampled answers, and each control's
answers to the same calls, are held to the reference.  One JSON line per
seed.  The benchmark's own runs never run a control.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from benchlib import cli  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--controls", default="stale,bf16")
    args = p.parse_args(argv)
    cli.cache_dirs(HERE.parent)
    from benchlib import spec

    cell = spec.load_cell(HERE.parent, HERE, args.workload, False)
    cli.host_threads()
    sys.path.insert(0, str(HERE.parent / "src"))
    import torch

    from benchlib import traffic

    torch.set_num_threads(cli.HOST_THREADS)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    controls = tuple(c for c in args.controls.split(",") if c)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        _, readings = traffic.run(traffic.Run(
            config=cell.config, traffic=cell.traffic, driver=cell.driver,
            seed=seed,
            seconds=args.seconds, trace=False,
            device=torch.device("cuda", 0), t_start=time.perf_counter(),
            controls=controls))
        print(json.dumps({"seed": seed, "s": time.perf_counter() - t0,
                          "limits": cell.traffic["limits"],
                          **{str(k if k is not None else "program"): v
                             for k, v in readings.items()}}), flush=True)
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
