"""The port's device mesh (``parallel/mesh.py``) on the CPU: the mesh of
a repeated device, row shards and their gather, replicas, the diagonal
schedule's ring direction, a mesh only where one is set, and the models
whose route has no sharded form (they train on one device and say so)."""

import logging

import numpy as np
import pytest
import torch

from mymedialite_tpu_torch.data.synthetic import (
    posonly_from_ratings, synthetic_ratings,
)
from mymedialite_tpu_torch.parallel import mesh as tmesh
from mymedialite_tpu_torch.parallel.mesh import (
    Mesh, diagonal_epoch, make_mesh, model_mesh,
)
from mymedialite_tpu_torch.utils.params import configure
from torch_threads import one_torch_thread  # noqa: F401


def test_mesh_of_a_repeated_device():
    mesh = make_mesh(devices=["cpu"] * 4)
    assert mesh.size == 4 and mesh.devices == (torch.device("cpu"),) * 4
    assert make_mesh(2, devices=["cpu"] * 4).size == 2
    with pytest.raises(ValueError):
        Mesh([])


def test_make_mesh_spans_the_visible_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    mesh = make_mesh()
    assert [str(d) for d in mesh.devices] == ["cuda:0", "cuda:1", "cuda:2"]
    assert make_mesh(2).size == 2
    with pytest.raises(ValueError):
        make_mesh(4)
    # several cards give a model no mesh until one is set
    class M:
        device = "cuda"
        mesh = None
    assert model_mesh(M()) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError):
        make_mesh()


def test_model_mesh_needs_two_devices():
    class M:
        device = "cpu"
        mesh = None
    m = M()
    assert model_mesh(m) is None
    m.mesh = make_mesh(devices=["cpu"])
    assert model_mesh(m) is None
    m.mesh = make_mesh(devices=["cpu"] * 2)
    assert model_mesh(m) is m.mesh


def test_shard_and_gather_rows():
    mesh = make_mesh(devices=["cpu"] * 4)
    t = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    shards = mesh.shard_rows(t)
    assert [s.shape[0] for s in shards] == [2] * 4
    shards[1][0, 0] = -1.0            # views of t on its own device
    assert t[2, 0] == -1.0
    assert torch.equal(mesh.gather_rows(shards), t)
    # 7 rows pad with one zero row to 2 a device (pad_rows_to_multiple)
    shards = mesh.shard_rows(t[:7])
    assert [s.shape[0] for s in shards] == [2] * 4
    gathered = mesh.gather_rows(shards)
    assert torch.equal(gathered[:7], t[:7]) and not gathered[7:].any()


def test_replicate_shares_one_copy_per_device():
    mesh = make_mesh(devices=["cpu"] * 3)
    t = torch.ones(4)
    copies = mesh.replicate(t)
    assert len(copies) == 3 and all(c is t for c in copies)


def test_diagonal_ring_direction():
    """Device d holds partition (d + k) % D at sub-epoch k: it receives
    from device d + 1 (the JAX package's ppermute pairs ((i + 1) % D, i));
    every partition is home after the epoch, empty cells are skipped and
    each cell sees the real entries of its rows of the order."""
    D = 4
    mesh = make_mesh(devices=["cpu"] * D)
    parts = [torch.tensor([float(p), 0.0]) for p in range(D)]
    counts = np.array([[(d + k) % 3 for k in range(D)] for d in range(D)])
    order = (np.arange(D * D * 2, dtype=np.int32).reshape(D, D, 2),)
    seen = []

    def cell(d, k, H, cols):
        assert int(H[0]) == (d + k) % D
        np.testing.assert_array_equal(cols[0].numpy(),
                                      order[0][d, k, :counts[d, k]])
        H[1] += 1.0
        seen.append((k, d))

    out = diagonal_epoch(mesh, parts, order, counts, cell)
    assert seen == [(k, d) for k in range(D) for d in range(D)
                    if counts[d, k]]
    for p, H in enumerate(out):
        visits = sum(1 for k, d in seen if (d + k) % D == p)
        assert H.tolist() == [p, visits]


def test_pad_rows_to_multiple():
    a = np.ones((5, 2), np.float32)
    out = tmesh.pad_rows_to_multiple(a, 4)
    assert out.shape == (8, 2) and not out[5:].any()
    assert tmesh.pad_rows_to_multiple(a, 5) is a


@pytest.fixture(scope="module")
def small_ratings():
    return synthetic_ratings(num_users=60, num_items=50, num_ratings=1200,
                             seed=3)


@pytest.mark.parametrize("name", ["SVDPlusPlus", "WRMF", "GSVDPlusPlus"])
def test_unsharded_models_log_their_one_device_route(name, small_ratings,
                                                     caplog):
    """Only a route without a sharded form logs that it runs on one
    device: GSVDPlusPlus does; SVDPlusPlus and WRMF have their sharded
    routes and log nothing."""
    from mymedialite_tpu_torch.data.arrays import InteractionData
    from mymedialite_tpu_torch.models.registry import (
        create_item_recommender, create_rating_predictor,
    )
    if name == "WRMF":
        m = create_item_recommender(name)
        m.feedback = posonly_from_ratings(small_ratings)
    else:
        m = create_rating_predictor(name)
        m.ratings = small_ratings
        m.item_attributes = InteractionData(
            np.arange(50, dtype=np.int32), np.arange(50, dtype=np.int32) % 4)
    configure(m, "num_factors=4 num_iter=1 device=cpu")
    m.mesh = make_mesh(devices=["cpu"] * 2)
    with caplog.at_level(logging.WARNING, logger="mymedialite_tpu_torch"):
        m.train()
    logged = any("no sharded form" in r.message and name in r.message
                 for r in caplog.records)
    assert logged is (name == "GSVDPlusPlus")
