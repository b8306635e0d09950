"""The sweep that found a serving cell's fixed rate: one engine set up as
the cell's, then the open loop at each offered rate in turn, each for
``--seconds``. The knee is the highest rate whose requests are all
answered with no backlog left at the window's close (sustained ≈
offered); the cell runs at about four fifths of it.

    python3 perfbench/sweep.py --workload <serve cell> --seed <n>
        --rates 40,80,120 --seconds 10 [--out file.json]

Prints one line ``[sweep] {...}`` per rate. The benchmark's runs never
run this.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    common.set_cache_dirs()
    w = common.cell(a.workload)
    common.require_cards(w["chips"])
    import torch
    from perfbench import serve
    from perfbench.traffic import gen
    from repro_torch.kernels import _build
    cfgj, mix = common.config(w["config"]), gen.load_mix(w["traffic"])
    dev = torch.device("cuda", 0)
    _build.build_all(serve.LIBS)
    client = serve.Client(mix, cfgj["vocab_size"])
    eng, _ = serve.build(cfgj, mix, a.seed, dev, client)
    out = []
    for j, rate in enumerate(float(r) for r in a.rates.split(",")):
        rec = serve.open_loop(eng, client, mix, a.seed + j, rate, a.seconds)
        out.append(rec)
        print("[sweep] " + json.dumps(rec), flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
