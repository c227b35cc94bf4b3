"""A glove-100-angular-shaped corpus, made on the device from the seed.

The distribution of the repo's bench corpus (``make_glove_like``): rows
// rows_per_topic unit-sphere topics, each row a topic plus per-dimension
Gaussian noise, L2-normalized, so each topic holds about a dozen rows and
the true top 10 straddles k-means leaves at glove-100 rates.  Queries are
drawn from the same topics.  Written in torch with one generator on the
device, in a few large calls.
"""

import torch


def make(spec: dict, seed: int, num_queries: int, device):
    """(rows, queries): float32 tensors on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n, d = spec["rows"], spec["dims"]
    n_topics = max(n // spec["rows_per_topic"], 64)
    topics = torch.randn((n_topics, d), generator=g, device=device)
    topics /= torch.linalg.norm(topics, dim=1, keepdim=True)

    def draw(m):
        a = torch.randint(0, n_topics, (m,), generator=g, device=device)
        x = topics[a]
        x += spec["noise"] * torch.randn((m, d), generator=g, device=device)
        x /= torch.linalg.norm(x, dim=1, keepdim=True)
        return x

    rows = draw(n)
    return rows, draw(num_queries)
