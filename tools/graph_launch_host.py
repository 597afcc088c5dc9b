"""How long the host waits in a graph's launch, on the card.

A replayed DreamerV3 window returns to the host at once at some widths and
only after most of its device time at others.  This times, on one NVIDIA
GPU, the host's return and the wall time of one eager call and one replay
(``parallel/compile.py``) of: 80 chained calls of the RSSM kernel and of
its plain version at B 16 and 1024; one DreamerV3 update (``chip_smoke.py``
phase 38's fused window) at XL with the RSSM kernel and with the plain
RSSM, and at S with the GRU kernel and with the plain GRU.  Medians of 5
(3 eager).  Run from the root of a checkout:

    python3 tools/graph_launch_host.py
"""
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import prep_blocks  # noqa: E402
from sheeprl_tpu_torch.data.device_replay import fused_sequence_train  # noqa: E402
from sheeprl_tpu_torch.ops import rssm  # noqa: E402
from sheeprl_tpu_torch.parallel.compile import GraphFunction  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")


def timed(fn, reps=5):
    host, wall = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host.append((t1 - t0) * 1e3)
        wall.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(host), statistics.median(wall)


def window_case(tag, overrides):
    cfg, trainer, rb = cs._fresh_window(torch, overrides)
    L, B = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.per_rank_batch_size)
    gen = torch.Generator(dev).manual_seed(1)

    def window(n, counter):
        return fused_sequence_train(trainer, rb, gen, B, L, n,
                                    lambda b: prep_blocks(b, trainer.cnn_keys, trainer.mlp_keys), counter)

    f = GraphFunction(window, name=tag, static_argnums=(0,), device=dev, generators=(gen,))
    counter = torch.zeros((), dtype=torch.int64, device=dev)
    f(1, counter)
    f(1, counter)
    eager = timed(lambda: window(1, counter), 3)
    graph = timed(lambda: f(1, counter))
    print(f"[{tag}] one update: eager host {eager[0]:.1f} ms wall {eager[1]:.1f} ms; replay host {graph[0]:.2f} ms "
          f"wall {graph[1]:.1f} ms", flush=True)
    del f, trainer, rb
    torch.cuda.empty_cache()


def kernel_case(tag, B, n=80):
    g = torch.Generator(dev).manual_seed(0)
    ZA, D, H = 1028, 1024, 4096
    w = [torch.randn(*s, generator=g, device=dev) * 0.02 for s in ((ZA, D), (D,), (D,), (D,), (D + H, 3 * H), (3 * H,), (3 * H,))]
    x, h = torch.randn(B, ZA, device=dev, generator=g), torch.randn(B, H, device=dev, generator=g)

    def chain(x, h):
        for _ in range(n):
            h = rssm.fused_rssm_recurrent(x, h, *w)
        return h

    def plain(x, h):
        for _ in range(n):
            h = rssm.rssm_recurrent_reference(x, h, *w)
        return h

    for name, fn in (("rssm kernel", chain), ("plain rssm", plain)):
        f = GraphFunction(fn, name=f"{tag}.{name}", device=dev)
        f(x, h)
        f(x, h)
        e = timed(lambda: fn(x, h), 3)
        r = timed(lambda: f(x, h))
        print(f"[{tag}] {n} x {name} at B {B}: eager host {e[0]:.2f} ms wall {e[1]:.2f}; replay host {r[0]:.3f} ms "
              f"wall {r[1]:.2f}", flush=True)


if __name__ == "__main__":
    import subprocess

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    kernel_case("kernels", 16)
    kernel_case("kernels", 1024)
    window_case("xl-fused", [*cs.XL_TRAIN, cs.FUSED])
    window_case("xl-plain", list(cs.XL_TRAIN))
    window_case("s-gru", list(cs.S_TRAIN))
    window_case("s-plain", [o for o in cs.S_TRAIN if "use_pallas" not in o])
