"""A sift-128-euclidean-shaped corpus, made on the device from the seed.

The distribution of the repo's SIFT-shaped corpus (``make_sift_like``):
non-negative, un-normalized rows with a hierarchy of topics (Gamma(2, 20)
per dimension), subtopics (Gaussian offsets of scale 6) and points
(Gaussian noise of scale 1.5), clipped at 0 as SIFT descriptors are, so
that true neighbours are genuinely close.  Queries are drawn from the
same subtopics.  Gamma(2, 1) is drawn as the sum of two unit
exponentials, -log(u1 * u2).
"""

import torch


def make(spec: dict, seed: int, num_queries: int, device):
    """(rows, queries): float32 tensors on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n, d = spec["rows"], spec["dims"]
    n_topics, subs = spec["topics"], spec["subtopics_per_topic"]
    u = torch.rand((2, n_topics, d), generator=g, device=device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    topics = -spec["topic_scale"] * torch.log(u[0] * u[1])
    offsets = spec["subtopic_scale"] * torch.randn(
        (n_topics * subs, d), generator=g, device=device)

    def draw(m):
        sub = torch.randint(0, n_topics * subs, (m,), generator=g,
                            device=device)
        x = topics[sub // subs] + offsets[sub]
        x += spec["point_scale"] * torch.randn((m, d), generator=g,
                                               device=device)
        return torch.clamp_min_(x, 0.0)

    rows = draw(n)
    return rows, draw(num_queries)
