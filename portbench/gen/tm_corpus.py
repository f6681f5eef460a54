"""A 20 Newsgroups-shaped corpus as a user's vectorizer hands it over:
a scipy CSR TF-IDF matrix, float64, rows L2-normalized.

The corpus is one draw from the configuration's ``data_seed``, the same
for every run: its content and its order set the work of a fit. The
simplex projections' rounds in kernel B2 took 0.92-1.56 ms a launch on
an H100 for four corpora drawn from four seeds, and phase-recipe fits of
one corpus took 1.04-1.25 s with its documents permuted by the seed
(1.07-1.25 s with its words permuted and ``random_state`` fixed), where
one input repeats to about 1%. So ``seed`` draws nothing here; the
configuration also fixes the estimators' ``random_state``. Drawn on the
device, in a few large calls:

1. word frequencies: a Zipf law over the vocabulary (``zipf_s``), the same
   for every topic, times a log-normal factor per (topic, word)
   (``topic_sigma``), so the head words are shared and each topic has
   words of its own;
2. each document's mixture over ``n_topics`` latent topics: a
   logistic-normal draw with temperature ``mix_tau`` (a few topics carry
   most of a document);
3. each document's length: log-normal around ``len_median`` tokens with
   ``len_sigma``, clipped to ``[len_min, len_max]``;
4. its tokens: multinomial draws from its word distribution;
5. TF-IDF as scikit-learn's ``TfidfTransformer`` computes it by default
   (``idf = ln((1 + n) / (1 + df)) + 1``, raw counts, rows L2-normalized).

``chip_smoke.zipf_corpus`` draws such a corpus on the host a document at
a time; this is its device form.
"""

import numpy as np
import scipy.sparse as sp
import torch


def make(config, seed, device):
    """``(X,)``: the (n, d) TF-IDF matrix of the configuration ``config``
    (its ``n`` documents, ``d`` words and generator parameters ``gen``) as
    scipy CSR; the same for every ``seed``."""
    params = config['gen']
    n, V, K = int(config['n']), int(config['d']), int(params['n_topics'])
    g = torch.Generator(device=device).manual_seed(int(params['data_seed']))
    f32 = dict(dtype=torch.float32, device=device)
    ranks = torch.arange(1, V + 1, **f32)
    logits = (-float(params['zipf_s']) * torch.log(ranks))[None, :] \
        + float(params['topic_sigma']) * torch.randn(K, V, generator=g,
                                                     **f32)
    topics = torch.softmax(logits, dim=1)                         # (K, V)
    mix = torch.softmax(float(params['mix_tau'])
                        * torch.randn(n, K, generator=g, **f32), dim=1)
    lens = torch.exp(np.log(float(params['len_median']))
                     + float(params['len_sigma'])
                     * torch.randn(n, generator=g, **f32))
    lens = lens.round().clamp(int(params['len_min']),
                              int(params['len_max'])).long()
    counts = torch.zeros(n, V, **f32)
    lmax = int(lens.max())
    block = max(1, int(2 ** 28 // (V * 4)))     # 256 MiB of probabilities
    for i in range(0, n, block):
        probs = mix[i:i + block] @ topics
        tokens = torch.multinomial(probs, lmax, replacement=True,
                                   generator=g)
        del probs
        keep = (torch.arange(lmax, device=device)[None, :]
                < lens[i:i + block, None]).float()
        counts[i:i + block].scatter_add_(1, tokens, keep)
        del tokens, keep
    df = (counts > 0).sum(0).double()
    idf = torch.log((1.0 + n) / (1.0 + df)) + 1.0
    X = counts.double() * idf[None, :]
    del counts
    X /= X.norm(dim=1, keepdim=True).clamp_min(1e-300)
    csr = X.to_sparse_csr()
    del X
    out = sp.csr_matrix((csr.values().cpu().numpy(),
                         csr.col_indices().cpu().numpy().astype(np.int32),
                         csr.crow_indices().cpu().numpy().astype(np.int32)),
                        shape=(n, V))
    return (out,)
