"""Card test of SOAR (marker ``cuda``; it skips without a card) against
the plain reference portbench/reference/soar.py, with no JAX, at a
middle size: the benchmark's glove-100-shaped corpus
(portbench/corpora/glove_like.py) at 300,000 x 100 unit rows, 500
leaves, 4,000 queries searched at 10 leaves with 150 candidates to the
reorder through K3 (int8 LUT), the pruned plan on the card.

* The assignment: the port's ``tokenize_database_soar`` on the card
  against ``assign``: primaries equal but at float32 ties, secondaries
  equal on >= 99.9% of rows, each disagreement a near-tie of the loss.
* No returned id outside the query's searched leaves (the reference's
  choice, ties within 1e-6 either way), no id twice in a row.
* Every distance within the benchmark's ``dist_gap`` limit (2e-5 of
  |q||x|) of the float64 one, and recall@10 against the leaf-restricted
  exact answer at least 0.98 (portbench/tools/soar_check.py's bar).

On a machine with a card (no JAX needed)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_soar.py
"""

import pytest
import torch

import scann_torch
from portbench.corpora import glove_like
from portbench.reference import soar as ref
import torch_threads  # noqa: F401  (torch threads per xdist worker)

pytestmark = pytest.mark.cuda

LAMBDA = 1.5
LEAVES = 10


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def soar_index(cuda):
    rows, q = glove_like.make({"rows": 300_000, "dims": 100,
                               "rows_per_topic": 12, "noise": 0.045},
                              29, 4_000, cuda)
    s = (scann_torch.builder(rows.cpu().numpy(), 10, "dot_product",
                             device="cuda").set_seed(3)
         .tree(num_leaves=500, num_leaves_to_search=LEAVES,
               training_sample_size=100_000, soar_lambda=LAMBDA,
               overretrieve_factor=2.0)
         .score_ah(2, anisotropic_quantization_threshold=0.2)
         .reorder(150).build())
    return s, rows, q


def test_assignment_on_the_card(soar_index):
    s, rows, _ = soar_index
    got = s.partitioner.tokenize_database_soar(rows, s.part_cfg.soar)
    c = ref.compare_assignment(rows, s.partitioner.centers, LAMBDA, got)
    assert c["secondary_is_primary"] == 0
    assert c["primary_not_tied"] == 0 and c["secondary_not_near_tie"] == 0
    assert c["secondary_differ"] <= 0.001 * c["secondary_compared"]


def test_answers_stay_in_the_searched_leaves_once(soar_index):
    s, rows, q = soar_index
    centers = s.partitioner.centers
    assignment = ref.assign(rows, centers, LAMBDA)
    marks = []
    s.stage_hook = marks.append
    try:
        idx, dist = s.search_batched(q.cpu().numpy(),
                                     leaves_to_search=LEAVES,
                                     pre_reorder_num_neighbors=150)
    finally:
        s.stage_hook = None
    assert "dedup" in marks
    idx = torch.as_tensor(idx, device=q.device).long()
    assert ref.outside_searched(idx, q, centers, assignment, LEAVES) == 0
    assert ref.repeated(idx) == 0
    d64 = (rows.double()[idx] * q.double()[:, None, :]).sum(-1)
    scale = torch.linalg.norm(q.double(), dim=1)[:, None] \
        * torch.linalg.norm(rows.double()[idx], dim=-1)
    gap = ((torch.as_tensor(dist, device=q.device).double() - d64).abs()
           / scale).max()
    assert float(gap) <= 2e-5
    want, _ = ref.search(rows, q, centers, assignment, LEAVES, 10)
    assert ref.recall(idx, want) >= 0.98
