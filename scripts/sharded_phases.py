"""Run chip_smoke.py's corpus-sharded phases alone, with the phases they build on.

[hybrid_1m] and then [hybrid_1m_sharded] on its rows and postings; [ivf_1m] and then
[shard_10m] on its index; [train]'s bf16 steps on data 4 and data 2 x tp 2 (from its
init and first batches, against one device); [mcp]'s store (built in a process of its
own from the start) and then [orch_sharded] on it, K8 timed at its shard shape. Each
sharded phase runs on 4 distinct cards when the machine has 4 or more, else on 4
logical shards of one card, and prints which. Every check of those phases applies;
the script exits non-zero if one fails.

    python3 scripts/sharded_phases.py [--seed 0]
"""
from __future__ import annotations

import argparse
import pathlib
import shutil
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as c  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed for all generated data")
    args = ap.parse_args(argv)
    dev, _ = c.device_phase()
    import torch

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="wax-sharded-"))
    store = c.start_mcp_store(tmp, args.seed, dev)
    try:
        c.build_phase()
        results, kept = {"K7": {}, "K8": {}}, {}
        c.hybrid_1m_phase(dev, results, keep=kept)
        c.hybrid_1m_sharded_phase(dev, kept)
        kept.clear()
        torch.cuda.empty_cache()
        c.ivf_1m_phase(dev, args.seed, results, keep=kept)
        c.shard_10m_phase(dev, args.seed, kept)
        kept.clear()
        torch.cuda.empty_cache()
        c.train_sharded_phase(dev, args.seed)
        torch.cuda.empty_cache()
        out, err = store[1].communicate(timeout=900)
        c.check(store[1].returncode == 0, f"the store's build exited {store[1].returncode}: {err.strip()[-500:]}")
        c.log("store", out.strip())
        c.orch_sharded_phase(dev, args.seed, store[0], results)
    finally:
        if store[1].poll() is None:
            store[1].kill()
            store[1].communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    print("sharded phases OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
