"""A MovieLens-25M-shaped ratings table as a user loads it from
``ratings.csv``: numpy ``(pairs (q, 2) int64, ratings (q,) float64)``,
user-major with each user's items ascending, users and items numbered
from 0, half stars 0.5-5.0.

``rs_ratings`` draws each user's items by a Gumbel top-k over one dense
``(n_users, n_items)`` array of keys, which at 162,541 × 59,047 would
not fit on one card. Here no ``(n, d)`` array exists: the keys are made
a block of ``block`` users at a time, and the noise of each (user, item)
comes from a hash of the seed, the user and the item, so the table does
not depend on the block size. The steps, drawn on the device:

1. ratings a user makes: ``rs_ratings._counts`` (``min_per_user`` each
   plus a water-filled, log-normal share of the rest, capped at
   ``max_per_user``, summing to ``n_obs`` exactly);
2. which items: each user's count of distinct items, the largest of
   ``log p_j + G_uj`` over the items, with Zipf-Mandelbrot popularity
   ``p ∝ (r + zipf_q)^-zipf_a`` over a random ranking of the items and
   ``G_uj`` a Gumbel draw from the hash (sampling without replacement in
   proportion to popularity);
3. the stars: a preference ``b_u + b_i + u·v`` plus noise, as
   ``rs_ratings`` draws it, cut at the quantiles that give the shares of
   the ten half-star levels in ``star_shares``.

The table is one draw from the configuration's ``data_seed``, the same
for every run (without it the run's seed draws it).
"""

from pathlib import Path

import numpy as np
import torch

from portbench.core.spec import load_module

# users whose keys are made at once: (block, n_items) float64 keys
BLOCK = 1024
_M32 = 0xFFFFFFFF


def _mix(x):
    """A 32-bit integer hash of the int64 tensor ``x`` (values below
    2**32), in place where it can be: two multiply-xorshift rounds, each
    product under 2**59."""
    x ^= x >> 16
    x *= 0x45D9F3B
    x &= _M32
    x ^= x >> 16
    x *= 0x45D9F3B
    x &= _M32
    x ^= x >> 16
    return x


def _items(counts, logp, seed, device, block=BLOCK):
    """``(users, items)`` int64: user u's ``counts[u]`` items, ascending,
    users in order. The Gumbel noise of (u, j) is a hash of (seed, u, j),
    so every block size gives the same items."""
    n_users, n_items = counts.shape[0], logp.shape[0]
    item = torch.arange(n_items, dtype=torch.int64, device=device)
    s = _mix(torch.tensor([int(seed) & _M32], dtype=torch.int64,
                          device=device))
    users, items = [], []
    for a in range(0, n_users, block):
        b = min(a + block, n_users)
        c = counts[a:b]
        u = torch.arange(a, b, dtype=torch.int64, device=device)
        h = _mix(_mix(u ^ s)[:, None] ^ item[None, :])
        g = h.double().add_(0.5).mul_(2.0 ** -32)
        del h
        g.log_().neg_().log_().neg_()         # Gumbel: -log(-log(U))
        g += logp[None, :]
        kmax = int(c.max())
        top = torch.topk(g, kmax, dim=1).indices
        del g
        take = torch.arange(kmax, device=device)[None, :] < c[:, None]
        top = torch.where(take, top, n_items).sort(dim=1).values
        users.append(u[:, None].expand(-1, kmax)[take])
        items.append(top[take])
        del top, take
    return torch.cat(users), torch.cat(items)


def make(config, seed, device, block=BLOCK):
    """``(pairs, ratings)`` of the configuration ``config``: its ``n``
    users, ``d`` items, ``n_obs`` ratings and generator parameters
    ``gen`` (``data_seed``, where given, in place of ``seed``)."""
    params = config['gen']
    n_users, n_items = int(config['n']), int(config['d'])
    data_seed = int(params.get('data_seed', seed))
    g = torch.Generator(device=device).manual_seed(data_seed)
    f64 = dict(dtype=torch.float64, device=device)
    counts = load_module('gen', 'rs_ratings',
                         Path(__file__).resolve().parent.parent)._counts(
        n_users, int(config['n_obs']), params, g, device)
    rank = torch.argsort(torch.rand(n_items, generator=g, **f64)) + 1
    logp = -float(params['zipf_a']) * torch.log(rank.double()
                                                + float(params['zipf_q']))
    if int(counts.max()) > n_items:
        raise ValueError('a user would rate %d of %d items'
                         % (int(counts.max()), n_items))
    users, items = _items(counts, logp, data_seed, device, block)
    # stars from a latent preference
    r = int(params['rank'])
    fs = float(params['factor_sigma'])
    U = fs * torch.randn(n_users, r, generator=g, **f64)
    Vf = fs * torch.randn(n_items, r, generator=g, **f64)
    bu = float(params['user_bias']) * torch.randn(n_users, generator=g,
                                                  **f64)
    bi = float(params['item_bias']) * torch.randn(n_items, generator=g,
                                                  **f64)
    score = (bu[users] + bi[items] + (U[users] * Vf[items]).sum(1)
             + float(params['noise'])
             * torch.randn(users.numel(), generator=g, **f64))
    shares = torch.tensor(params['star_shares'], **f64)
    cuts = torch.sort(score).values[
        (torch.cumsum(shares, 0)[:-1] * (score.numel() - 1)).round().long()]
    stars = 0.5 + 0.5 * torch.searchsorted(cuts, score).double()
    pairs = torch.stack([users, items], 1).cpu().numpy().astype(np.int64)
    return pairs, stars.cpu().numpy()
