"""Online unsupervised clustering with a TNN column, on the PyTorch port.

The torch form of ``examples/tnn_clustering.py``: a stream of
temporal-coded spike volleys from 3 latent classes (made from a numpy
seed) trains a 16-input x 3-neuron TNN layer online with STDP + WTA —
once with the exact compact-PC dendrite and once with Catwalk (k=2) — and
the script reports clustering purity by thirds of the stream and the
silicon cost of each neuron (:mod:`repro_torch.core.hwcost`). A final
section trains a two-layer :mod:`repro_torch.core.network` stack greedily
with minibatch STDP (B=8) and reports layer 2's purity.

On a CUDA device every gamma cycle's neuron bank is one launch of the RNL
layer kernel. ``--device cpu`` runs the kernels' plain versions instead.

Run:  PYTHONPATH=src python examples/tnn_clustering_torch.py \\
          [--volleys 600] [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core import coding, column, hwcost, layer, network, stdp
from repro_torch.kernels.common import resolve_device

#: the example's dendrites: (name, threshold, k)
DENDRITES = (("pc_compact", 18, 2), ("catwalk", 12, 2))


def make_stream(rng: np.random.Generator, m: int, n: int = 16,
                t_max: int = 16, active: int = 4, classes: int = 3):
    """(volleys (m, n) int32, labels (m,)): class c lights ``active`` lines
    from ``c * n // 3`` at times jittered in [0, 3); the rest is silent."""
    labels = rng.integers(0, classes, m)
    jitter = rng.integers(0, 3, (m, n))
    t = np.full((m, n), 99)
    for c in range(classes):
        lo = c * n // 3
        block = np.where((labels == c)[:, None],
                         jitter[:, lo:lo + active], 99)
        t[:, lo:lo + active] = block
    volleys = np.where(t >= t_max, coding.NO_SPIKE, t).astype(np.int32)
    return volleys, labels.astype(np.int64)


def stdp_config() -> stdp.STDPConfig:
    return stdp.STDPConfig(mu_capture=1.0, mu_backoff=1.0, mu_search=0.5)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--volleys", type=int, default=600)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    volleys_np, labels_np = make_stream(np.random.default_rng(42),
                                        args.volleys)
    volleys = torch.from_numpy(volleys_np).to(dev)
    labels = torch.from_numpy(labels_np).to(dev)
    scfg = stdp_config()
    model = hwcost.calibrated()
    m = args.volleys

    for dendrite, thr, k in DENDRITES:
        cfg = layer.TNNLayer(n_columns=1, rf_size=16, n_neurons=3,
                             threshold=thr, t_steps=16, dendrite=dendrite,
                             k=k, stdp=scfg)
        w0 = layer.init_layer(torch.Generator().manual_seed(0), cfg, dev)
        _, winners = layer.train_layer(w0, volleys, cfg, batch_size=1)
        winners = winners[:, 0]           # single column
        for lo, hi in ((0, m // 3), (m // 3, 2 * m // 3), (2 * m // 3, m)):
            p = column.cluster_purity(winners[lo:hi], labels[lo:hi], 3, 3)
            print(f"{dendrite:12s} volleys {lo:4d}-{hi:4d}: "
                  f"purity {float(p):.3f}")
        cost = model.neuron_report(dendrite, 16, k)
        print(f"{dendrite:12s} neuron cost: {cost['area_um2']:.1f} um^2, "
              f"{cost['total_uw']:.1f} uW x 3 neurons\n")

    # Two stacked Catwalk layers, trained greedily with minibatch STDP
    # (B=8): layer 1's three WTA output lines feed layer 2.
    l1 = layer.TNNLayer(n_columns=1, rf_size=16, n_neurons=3, threshold=12,
                        t_steps=16, dendrite="catwalk", k=2, stdp=scfg)
    l2 = layer.TNNLayer(n_columns=1, rf_size=3, n_neurons=3, threshold=2,
                        t_steps=16, dendrite="catwalk", k=2, stdp=scfg)
    net = network.make_network([l1, l2])
    m8 = m - m % 8
    params = network.init_network(torch.Generator().manual_seed(0), net,
                                  dev)
    _, winners_per_layer = network.train_network(params, volleys[:m8], net,
                                                 batch_size=8)
    p2 = column.cluster_purity(winners_per_layer[-1][m8 // 2:, 0],
                               labels[m8 // 2:m8], 3, 3)
    print(f"2-layer TNNNetwork (minibatch B=8) layer-2 purity "
          f"(trailing half): {float(p2):.3f}")


if __name__ == "__main__":
    main()
