"""One (arch x shape) of the production dry-run on the PyTorch/CUDA port:
the census of a train or serve step on the production meshes (16x16,
2x16x16) under a fake process group, on ``meta`` tensors, and its
roofline terms against the H100. It is the unit of the whole matrix
(``python -m repro_torch.launch.dryrun --arch all ...``) and the
counterpart of ``examples/multi_pod_dryrun.py``, which lowers and
compiles the pair instead. On the card (the default) the pair's
one-card probe (``dryrun.probe_on_card``) follows the census.

    PYTHONPATH=src python examples/multi_pod_dryrun_torch.py \
        --arch granite-3-2b --shape decode_32k --mesh both --device cpu
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch import dryrun

OUT = dryrun.ARTIFACT_DIR  # the records, one JSON file a pair and mesh (git-ignored)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) also probes the pair on the card; cpu only "
                         "takes the census")
    args = ap.parse_args(argv)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    recs = []
    for mp in meshes:
        rec = dryrun.lower_one(args.arch, args.shape, mp)
        dryrun.save(rec, OUT)
        recs.append(rec)
    if args.device != "cpu":
        rec = dryrun.probe_on_card(args.arch, args.shape, device=args.device)
        print(f"[dryrun] {args.arch} {args.shape} card: {json.dumps(rec['full_depth'])}")
        recs.append(rec)
    return recs


if __name__ == "__main__":
    main()
