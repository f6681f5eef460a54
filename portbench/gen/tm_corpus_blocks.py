"""A large bag-of-words corpus (the NYTimes shape) as a user's
vectorizer hands it over: a scipy CSR TF-IDF matrix, float64, rows
L2-normalized.

``tm_corpus`` counts tokens into one dense (n, V) array, which at
300,000 × 102,660 would take 123 GB in float32. Here no (n, V) array
exists: the documents are drawn on the device a block at a time (as many
as ``BLOCK_BYTES`` of word probabilities hold), each block's tokens are
reduced to its distinct (document, word) pairs and their counts at once,
and the TF-IDF values are computed on those pairs. The draws:

1. the words' ids: the vocabulary as its file lists it, not by
   frequency, so word ``j`` takes the Zipf rank ``zipf_offset + 1 +
   perm[j]`` of a permutation ``perm``; the ``zipf_offset`` most frequent
   ranks are the stop words, removed from the vocabulary;
2. word frequencies: that Zipf law (``zipf_s``) times a log-normal factor
   per (topic, word) (``topic_sigma``), as ``tm_corpus``;
3. each document's mixture over ``n_topics`` latent topics: a
   logistic-normal draw with temperature ``mix_tau``;
4. each document's length: log-normal around ``len_median`` tokens with
   ``len_sigma``, clipped to ``[len_min, len_max]``;
5. its tokens, bursty: ``length / (1 + burst)`` multinomial draws from
   its word distribution, each draw counted ``1 + Poisson(burst)`` times
   (a word that occurs in a document tends to recur in it);
6. TF-IDF as scikit-learn's ``TfidfTransformer`` computes it by default
   (``idf = ln((1 + n) / (1 + df)) + 1``, raw counts, rows
   L2-normalized), each row's squared sum a segment sum in column order
   (no atomics, so the card gives the same values on every run).

The corpus is one draw from the configuration's ``data_seed``, the same
for every run; ``seed`` draws nothing.
"""

import numpy as np
import scipy.sparse as sp
import torch

# bytes of one block's (block, V) float32 word probabilities
BLOCK_BYTES = 1 << 28


def draw(config, device):
    """``(rows, cols, counts, tokens)`` of the configuration's corpus on
    ``device``: the distinct (document, word) pairs in row-major order
    (int32 rows and columns, int32 counts) and the tokens drawn."""
    params = config['gen']
    n, V, K = int(config['n']), int(config['d']), int(params['n_topics'])
    block = max(1, BLOCK_BYTES // (V * 4))
    burst = float(params['burst'])
    g = torch.Generator(device=device).manual_seed(int(params['data_seed']))
    f32 = dict(dtype=torch.float32, device=device)
    ranks = (torch.randperm(V, generator=g, device=device)
             + 1 + int(params['zipf_offset'])).float()
    logits = (-float(params['zipf_s']) * torch.log(ranks))[None, :] \
        + float(params['topic_sigma']) * torch.randn(K, V, generator=g,
                                                     **f32)
    topics = torch.softmax(logits, dim=1)                         # (K, V)
    del logits
    mix = torch.softmax(float(params['mix_tau'])
                        * torch.randn(n, K, generator=g, **f32), dim=1)
    lens = torch.exp(np.log(float(params['len_median']))
                     + float(params['len_sigma'])
                     * torch.randn(n, generator=g, **f32))
    lens = lens.round().clamp(int(params['len_min']),
                              int(params['len_max']))
    fresh = (lens / (1.0 + burst)).round().clamp_min(1).long()
    rows, cols, counts = [], [], []
    for a in range(0, n, block):
        b = min(a + block, n)
        probs = mix[a:b] @ topics
        lmax = int(fresh[a:b].max())
        tokens = torch.multinomial(probs, lmax, replacement=True,
                                   generator=g)
        del probs
        times = 1.0 + torch.poisson(torch.full(tokens.shape, burst, **f32),
                                    generator=g)
        keep = (torch.arange(lmax, device=device)[None, :]
                < fresh[a:b, None])
        doc = torch.arange(a, b, dtype=torch.int64, device=device)
        key = (doc[:, None] * V + tokens)[keep]
        times = times[keep]
        del tokens, keep
        key, inv = torch.unique(key, sorted=True, return_inverse=True)
        cnt = torch.zeros(key.shape[0], **f32).index_add_(0, inv, times)
        rows.append((key // V).int())
        cols.append((key % V).int())
        counts.append(cnt.int())
        del key, inv, times, cnt
    counts = torch.cat(counts)
    return torch.cat(rows), torch.cat(cols), counts, int(counts.sum())


def tfidf_values(rows, cols, counts, n, V):
    """The TF-IDF values (float64) of the row-major pairs ``(rows, cols)``
    with their token counts: smooth idf over the pairs' document
    frequencies, each row scaled to unit L2 norm."""
    df = torch.bincount(cols.long(), minlength=V).double()
    idf = torch.log((1.0 + n) / (1.0 + df)) + 1.0
    vals = counts.double() * idf[cols.long()]
    per_row = torch.bincount(rows.long(), minlength=n)
    norms = torch.segment_reduce(vals * vals, 'sum', lengths=per_row).sqrt()
    vals /= norms.clamp_min(1e-300).repeat_interleave(
        per_row, output_size=vals.shape[0])
    return vals, per_row


def make(config, seed, device):
    """``(X,)``: the (n, d) TF-IDF matrix of the configuration ``config``
    (its ``n`` documents, ``d`` words and generator parameters ``gen``)
    as scipy CSR; the same for every ``seed``."""
    n, V = int(config['n']), int(config['d'])
    rows, cols, counts, _ = draw(config, device)
    vals, per_row = tfidf_values(rows, cols, counts, n, V)
    del rows, counts
    indptr = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(per_row.cpu().numpy(), out=indptr[1:])
    out = sp.csr_matrix((vals.cpu().numpy(), cols.cpu().numpy(), indptr),
                        shape=(n, V))
    return (out,)
