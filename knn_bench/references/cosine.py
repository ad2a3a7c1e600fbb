"""Cosine similarity, the score of metric "cosine", worked out from the raw
vectors: each is divided by its own norm here.

The key is the negated similarity (smaller is nearer); the index reports
the similarity. ``mm(a, b)`` is a · bᵀ in the caller's precision.
"""

#: Gaps and errors are read in similarity, absolute.
RELATIVE = False


def _unit(x):
    return x / (x * x).sum(-1, keepdim=True).sqrt()


def keys(q, p, mm):
    """(m, k) queries, (nb, k) points -> (m, nb) negated similarity."""
    return -mm(_unit(q), _unit(p))


def pair_keys(q, p):
    """(m, k) queries, (m, K, k) points -> (m, K) negated similarity."""
    return -(_unit(p) * _unit(q)[:, None, :]).sum(-1)


def score(key):
    return -key


def score_key(score):
    """The key of a reported score (the inverse of ``score``)."""
    return -score
