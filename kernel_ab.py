"""Time the port's K2 (kmeans_assign) and K3 (flash_decode) kernels at
their path shapes in several checkouts, on one card in one call, so that
two versions are compared under the same clocks and power limit.

    python3 kernel_ab.py TREE [TREE ...]

Each TREE is the root of a checkout (``src/repro_torch`` inside). The
trees run in the order given, each in a process of its own that builds
its kernels into its own ``build/`` directory; give them as A B B A to
see the drift between the ends. Each tree prints one JSON line: every
case's device time alone in ms, a CUDA graph of ``CALLS`` calls replayed
and divided by ``CALLS`` (``graph_ms`` of ``chip_smoke.py``), so that
the replay's own cost drops out of the small kernels' times. A case
that a tree's wrapper refuses prints ``refused``. The card's
``nvidia-smi`` name and power limit come first. It imports nothing of
JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

CALLS = 20


def graph_ms(torch, fn, reps: int = 100, trials: int = 7) -> float:
    """Median over ``trials`` of the mean replay time of a CUDA graph of
    ``CALLS`` ``fn`` calls, after a warm-up, over ``CALLS``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CALLS):
            fn()
    for _ in range(5):
        graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps / CALLS)
    return statistics.median(times)


def k2_cases(torch, dev):
    """(label, X, C, k_active): the coordinator's shapes (the round's,
    the grid's with k_active, the LM swarm's, mamba2's), a one-tile C
    over many rows, and a C of 12 centroids (two tiles)."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    ka = torch.tensor(2, dtype=torch.int32, device=dev)
    return [
        ("(14,56)x(3,56)", rand(14, 56), rand(3, 56), None),
        ("(14,56)x(5,56) k_active 2", rand(14, 56), rand(5, 56), ka),
        ("(6,222)x(2,222)", rand(6, 222), rand(2, 222), None),
        ("(6,868)x(2,868)", rand(6, 868), rand(2, 868), None),
        ("(70000,56)x(3,56)", rand(70_000, 56), rand(3, 56), None),
        ("(4096,100)x(12,100)", rand(4096, 100), rand(12, 100), None),
    ]


def k3_cases(torch, dev):
    """(label, q, k, v, pos): granite's and kimi-k2's decode at the serve
    path's larger bucket, internvl2's (G 6) at S 4,096 and a D of 80 on
    the 128 layout, the cache stored (B,S,KV,D) as the engine keeps it,
    rows at S, 3S/4, S/2 and S/4 less one."""
    gen = torch.Generator(device=dev).manual_seed(1)
    bf16, f16 = torch.bfloat16, torch.float16
    out = []
    for label, H, D, S, qdt, cdt in (
            ("granite bf16", 32, 64, 2048, bf16, bf16),
            ("granite fp16 on e5m2", 32, 64, 2048, f16, torch.float8_e5m2),
            ("kimi-k2 bf16", 64, 112, 2048, bf16, bf16),
            ("kimi-k2 bf16 on e4m3", 64, 112, 2048, bf16, torch.float8_e4m3fn),
            ("internvl2 bf16", 48, 128, 4096, bf16, bf16),
            ("D 80 fp16", 32, 80, 4096, f16, f16)):
        q = torch.randn((4, H, 1, D), generator=gen, device=dev).to(qdt)
        k, v = (torch.randn((4, S, 8, D), generator=gen, device=dev).to(cdt).transpose(1, 2)
                for _ in range(2))
        pos = torch.tensor([S - 1, 3 * S // 4 - 1, S // 2 - 1, S // 4 - 1], dtype=torch.int32,
                           device=dev)
        out.append((f"K3 {label} (4,{H},1,{D}) vs (4,{S},8,{D})", q, k, v, pos))
    return out


def one_tree(tree: Path) -> int:
    import torch
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import flash_decode, kmeans_assign
    dev = torch.device("cuda")
    rows = {}
    for label, X, C, ka in k2_cases(torch, dev):
        rows[f"K2 {label}"] = graph_ms(torch, lambda X=X, C=C, ka=ka:
                                       kmeans_assign.kmeans_assign(X, C, ka))
    for label, q, k, v, pos in k3_cases(torch, dev):
        try:
            flash_decode.flash_decode(q, k, v, pos, 0)
        except (TypeError, ValueError):
            rows[label] = "refused"
            continue
        rows[label] = graph_ms(torch, lambda q=q, k=k, v=v, pos=pos:
                               flash_decode.flash_decode(q, k, v, pos, 0))
    print(json.dumps({"tree": str(tree), "ms": rows}), flush=True)
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        return one_tree(Path(sys.argv[2]).resolve())
    trees = [Path(t).resolve() for t in sys.argv[1:]]
    if not trees or not all((t / "src" / "repro_torch").is_dir() for t in trees):
        print("kernel_ab: give the roots of checkouts (each holding src/repro_torch)",
              file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for t in trees:
        subprocess.run([sys.executable, __file__, "--one", str(t)], check=True, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main())
