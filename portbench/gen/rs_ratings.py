"""A MovieLens-shaped ratings table as a user loads it from
``ratings.dat``: numpy ``(pairs (q, 2) int64, ratings (q,) float64)``,
user-major, users and items numbered from 0, whole stars 1-5.

The table is one draw from the configuration's ``data_seed`` where it
gives one, the same for every run: with the held-out early stop, the
table sets how many sweeps a fit runs before the stop, and so the work.
Without ``data_seed`` the run's seed draws it. Drawn on the device, in a
few large calls:

1. ratings a user makes: ``min_per_user`` each plus a share of the rest
   in proportion to a log-normal activity (``activity_sigma``), capped at
   ``max_per_user`` (water-filled), rounded by largest remainder so the
   total is ``n_ratings`` exactly;
2. which items: each user's count of distinct items drawn without
   replacement with Zipf-Mandelbrot popularity ``(r + zipf_q)^-zipf_a``
   over a random ranking of the items (Gumbel top-k);
3. the stars: a preference ``b_u + b_i + u·v`` (biases with
   ``user_bias``/``item_bias`` spread, ``rank`` latent factors of spread
   ``factor_sigma``) plus noise ``noise``, cut at the quantiles that give
   the shares of 1-5 stars in ``star_shares``.

``chip_smoke.synth_ratings`` draws uniform pairs from a low-rank score on
the host; this is its device form, with skewed activity and popularity
and no repeated pair.
"""

import numpy as np
import torch


def _counts(n_users, total, params, g, device):
    """Ratings per user, (n_users,) int64 summing to ``total``."""
    lo, hi = int(params['min_per_user']), int(params['max_per_user'])
    act = torch.exp(float(params['activity_sigma'])
                    * torch.randn(n_users, generator=g, dtype=torch.float64,
                                  device=device))
    share = torch.zeros(n_users, dtype=torch.float64, device=device)
    free = torch.ones(n_users, dtype=torch.bool, device=device)
    rest = float(total - lo * n_users)
    for _ in range(64):
        # water-filling: the capped users keep the cap, the others share
        # what is left in proportion to their activity
        left = rest - float(share[~free].sum())
        share = torch.where(free, act * left / act[free].sum(), share)
        over = free & (share > hi - lo)
        if not bool(over.any()):
            break
        share = torch.where(over, float(hi - lo), share)
        free &= ~over
    base = share.floor()
    missing = int(round(rest - float(base.sum())))
    frac = share - base
    order = torch.argsort(frac, descending=True, stable=True)
    base[order[:missing]] += 1
    return base.long() + lo


def make(config, seed, device):
    """``(pairs, ratings)`` of the configuration ``config``: its ``n``
    users, ``d`` items, ``n_obs`` ratings and generator parameters
    ``gen`` (``data_seed``, where given, in place of ``seed``)."""
    params = config['gen']
    n_users, n_items = int(config['n']), int(config['d'])
    g = torch.Generator(device=device).manual_seed(
        int(params.get('data_seed', seed)))
    f64 = dict(dtype=torch.float64, device=device)
    counts = _counts(n_users, int(config['n_obs']), params, g, device)
    # item popularity over a random ranking of the items
    rank = torch.argsort(torch.rand(n_items, generator=g, **f64)) + 1
    logp = -float(params['zipf_a']) * torch.log(rank.double()
                                                + float(params['zipf_q']))
    # Gumbel top-k: each user's first counts[u] items by perturbed
    # log-popularity, distinct by construction
    u = torch.rand(n_users, n_items, generator=g, dtype=torch.float32,
                   device=device).clamp_min(1e-20)
    keys = logp.float()[None, :] - torch.log(-torch.log(u))
    del u
    order = torch.argsort(keys, dim=1, descending=True)
    del keys
    take = (torch.arange(n_items, device=device)[None, :]
            < counts[:, None])
    users = torch.arange(n_users, device=device)[:, None].expand(
        n_users, n_items)[take]
    items = order[take]
    del order, take
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
    stars = 1.0 + (score[:, None] > cuts[None, :]).sum(1).double()
    pairs = torch.stack([users, items], 1).cpu().numpy().astype(np.int64)
    return pairs, stars.cpu().numpy()
