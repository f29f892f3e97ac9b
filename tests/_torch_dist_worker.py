"""Worker of tests/test_torch_distributed_multiprocess.py: one of two OS
processes that join a ``torch.distributed`` group (gloo over localhost
TCP) and split the PatchMatch sweep of 8 reference views between them.

Each process rebuilds ``__graft_entry__._make_example(h=96, w=128, v=2)``
from the same numpy draws through the port's ``densify._build_pm_data``,
sweeps its half of 8 perturbed states with the port's
``patchmatch.sweep`` on the CPU, then:

  1. ``all_gather``s the depths and compares them with a serial sweep of
     all 8 views computed locally (at least 0.999 within 1e-3 relative);
  2. ``all_reduce``s the depth sum into the global mean, against the
     serial mean.

Imports torch and the port only, never JAX. Usage:
_torch_dist_worker.py <port> <world_size> <rank>; prints "DIST_OK ..."
on success.
"""
import os
import sys


def _example(h=96, w=128, v=2):
    """The port's counterpart of __graft_entry__._make_example: (data,
    state, opts, v) on the CPU."""
    import numpy as np
    import torch

    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.densify import _build_pm_data
    from openmvs_tpu_torch.geometry.camera import Camera
    from openmvs_tpu_torch.ops import patchmatch

    rng = np.random.default_rng(0)
    f = 0.9 * w
    K = np.array([[f, 0, w / 2 - 0.5], [0, f, h / 2 - 0.5], [0, 0, 1.0]])
    ref_cam = Camera(K, np.eye(3), np.zeros(3))
    nbr_cams = [Camera(K, np.eye(3), np.array([0.3 * (j + 1), 0.05 * j, 0.0]))
                for j in range(v)]
    ref = rng.uniform(0, 1, (h, w)).astype(np.float32)
    nbrs = [rng.uniform(0, 1, (h, w)).astype(np.float32) for _ in range(v)]
    opts = DenseOptions(sub_resolution_levels=0, estimation_iters=1)
    data = _build_pm_data(ref, ref_cam, nbrs, nbr_cams, opts, 2.0, 10.0, None, None,
                          device="cpu")
    seed_d = torch.full((h, w), 5.0)
    seed_n = torch.tensor([0, 0, -1.0]).expand(h, w, 3)
    state = patchmatch.init_state(data, opts, (0, 0), seed_d, seed_n, v, False)
    return data, state, opts, v


def main() -> None:
    port, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import numpy as np
    import torch
    import torch.distributed as dist

    from openmvs_tpu_torch.ops import patchmatch

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        print(f"joined: rank {rank}/{world}", flush=True)
        data, state, opts, v = _example()
        n_views = 4 * world
        key = (0, 0)

        def sweep(i):
            # per-view variation so the views are distinguishable
            st = patchmatch.PMState(*(x * (1.0 + 0.01 * i) for x in state))
            return patchmatch.sweep(st, data, opts, key, v, False).depth

        mine = torch.stack([sweep(i) for i in range(rank * 4, rank * 4 + 4)])
        parts = [torch.empty_like(mine) for _ in range(world)]
        dist.all_gather(parts, mine)
        gathered = torch.cat(parts).numpy()
        serial = torch.stack([sweep(i) for i in range(n_views)]).numpy()
        rel = np.abs(gathered - serial) / np.maximum(np.abs(serial), 1e-6)
        close = float((rel < 1e-3).mean())
        if close < 0.999:
            raise SystemExit(f"sweep parity {close:.5f}")

        total = mine.sum().reshape(1)
        dist.all_reduce(total)
        gm = float(total) / serial.size
        want = float(serial.mean())
        if abs(gm - want) > 1e-3 * max(abs(want), 1.0):
            raise SystemExit(f"global mean {gm} != {want}")
        print(f"DIST_OK rank={rank} views={n_views} parity={close:.5f} "
              f"global_mean={gm:.5f}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
