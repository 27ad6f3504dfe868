"""The reference's STDP uniforms, rebuilt from its key tree as numpy.

The port cannot reproduce ``jax.random``'s draws, so its stochastic rule
takes them through ``draws=``. Each function returns the uniforms the
reference draws from ``key`` at one level of its call tree:
``network.step`` splits by layer, ``layer_step`` by column,
``stdp_update_column_minibatch`` by volley then by neuron,
``stdp_update_column`` by neuron, and ``stdp_delta`` takes
``split(key, 1)[0]`` and draws ``uniform((n,))``; the stream trainers split
by step.
"""

import jax
import numpy as np


def delta(key, shape):
    """``stdp_delta``'s uniforms."""
    return np.array(jax.random.uniform(jax.random.split(key, 1)[0], shape))


def column(key, q, n):
    """``stdp_update_column``'s uniforms, (q, n)."""
    return np.stack([delta(k, (n,)) for k in jax.random.split(key, q)])


def minibatch(key, bsz, q, n):
    """``stdp_update_column_minibatch``'s uniforms, (B, q, n)."""
    return np.stack([column(k, q, n) for k in jax.random.split(key, bsz)])


def layer(key, lc, bsz):
    """``layer_step``'s uniforms for a reference ``TNNLayer``,
    (C, B, Q, rf_total)."""
    return np.stack([minibatch(k, bsz, lc.n_neurons, lc.rf_total)
                     for k in jax.random.split(key, lc.n_columns)])


def network(key, net, bsz):
    """``network.step``'s uniforms: one (C, B, Q, rf_total) array a
    layer."""
    return [layer(k, lc, bsz)
            for k, lc in zip(jax.random.split(key, len(net.layers)),
                             net.layers)]


def stream(key, steps, one):
    """A stream trainer's uniforms: ``one(step_key)`` for each of the
    ``steps`` keys of ``split(key, steps)``, stacked (arrays) or stacked
    entry by entry (lists, one entry a layer)."""
    per_step = [one(k) for k in jax.random.split(key, steps)]
    if isinstance(per_step[0], list):
        return [np.stack(col) for col in zip(*per_step)]
    return np.stack(per_step)
