"""The plain training routes' epochs, timed, for the tree at ROOT (this
checkout, or a parent's unpacked beside it).

    python3 exp_torch_plain_routes.py ROOT LABEL

On the card, each route that scatters through ``ops/sgd.py add_rows``
(since the parent of this script's first use, ``index_add_`` before):
SocialMF, TimeAwareBaseline, TimeAwareBaselineWithFrequencies and
BPRSLIM with ``quality.py``'s options on its ML-1M-shaped data (train
seconds over its epochs), SVDPlusPlus with frequency regularization (the
grouped epoch, k=20, 5 epochs) on the same ratings, and BPRMF (k=40, 3
epochs) on the minibatch epoch at the big catalog
(``synthetic_ratings(500_000, 2_200_000, 10_000_000, seed=7)``), whose
epochs are timed one by one (host clock between synchronizes). Each route trains twice from one seed
and reports whether its tables are equal bit for bit. Prints one line
``PROBE {json}``. To compare two trees, run them in turns in one call
(parent, change, change, parent). ``--small`` rehearses it on the CPU
at quality.py's --small scale.
"""
import json
import sys
import time

root, label = sys.argv[1], sys.argv[2]
small = "--small" in sys.argv[3:]
sys.path.insert(0, root)
import torch  # noqa: E402

from mymedialite_tpu_torch import quality  # noqa: E402
from mymedialite_tpu_torch.data.synthetic import (  # noqa: E402
    posonly_from_ratings, split_ratings, synthetic_ratings)
from mymedialite_tpu_torch.models.registry import (  # noqa: E402
    create_item_recommender, create_rating_predictor)

assert quality.__file__.startswith(root), quality.__file__
dev = torch.device("cpu" if small else "cuda")
scale = 0.05 if small else 1.0


def sync():
    if dev.type == "cuda":
        torch.cuda.synchronize()


def tables(model):
    """The model's tensors: its tensor attributes and those of its dict
    attributes."""
    out = {}
    for k, v in vars(model).items():
        if isinstance(v, torch.Tensor):
            out[k] = v
        elif isinstance(v, dict):
            out.update({f"{k}.{j}": t for j, t in v.items()
                        if isinstance(t, torch.Tensor)})
    return out


def trained(create, name, opts, train, extra=None, epoch=None):
    """Train one model of ``name`` (epochs timed through ``epoch`` =
    (module, function name) where given); returns (seconds, epoch ms,
    its tables)."""
    model = create(name, f"{opts} device={dev.type}")
    for k, v in (extra or {}).items():
        setattr(model, k, v)
    if hasattr(model, "feedback") and create is create_item_recommender:
        model.feedback = train
    else:
        model.ratings = train
    ms, real = [], None
    if epoch is not None:
        mod, fn = epoch
        real = getattr(mod, fn)

        def timed(*a, **k):
            sync()
            t = time.perf_counter()
            out = real(*a, **k)
            sync()
            ms.append((time.perf_counter() - t) * 1e3)
            return out
        setattr(mod, fn, timed)
    try:
        sync()
        t0 = time.perf_counter()
        model.train()
        sync()
        seconds = time.perf_counter() - t0
    finally:
        if real is not None:
            setattr(mod, fn, real)
    return seconds, ms, {k: v.detach().clone() for k, v in
                         tables(model).items()}


def both(*args, **kw):
    (s1, ms1, t1), (s2, ms2, t2) = trained(*args, **kw), trained(*args, **kw)
    return dict(train_s=[s1, s2], epoch_ms=[ms1, ms2],
                tables_equal=t1.keys() == t2.keys() and all(
                    torch.equal(t1[k], t2[k]) for k in t1))


out = dict(label=label, root=root, card=torch.cuda.get_device_name(0)
           if dev.type == "cuda" else "cpu")
train, test, P_true = quality.rating_data(scale, dev)
rows = dict(quality.RATING_CONFIGS + quality.TIME_AWARE_CONFIGS
            + quality.ITEM_CONFIGS)
out["SocialMF"] = both(create_rating_predictor, "SocialMF",
                       rows["SocialMF"], train,
                       extra=dict(user_relation=quality.trust_graph(P_true)))
out["SVDPlusPlus grouped"] = both(
    create_rating_predictor, "SVDPlusPlus",
    "num_factors=20 num_iter=5 learn_rate=0.003 "
    "frequency_regularization=true", train)
ttrain, _ = quality.timed_data(scale, dev)
for name in ("TimeAwareBaseline", "TimeAwareBaselineWithFrequencies"):
    out[name] = both(create_rating_predictor, name, rows[name], ttrain)
ptrain, _ = quality.implicit_data(scale)
out["BPRSLIM"] = both(create_item_recommender, "BPRSLIM", rows["BPRSLIM"],
                      ptrain)
del train, test, ttrain, ptrain
if dev.type == "cuda":
    torch.cuda.empty_cache()
from mymedialite_tpu_torch.ops import bpr  # noqa: E402
from mymedialite_tpu_torch.ops import plan  # noqa: E402
if small:
    plan.RESIDENT_ITEM_TABLE_BYTES = 1024
big = synthetic_ratings(
    **(dict(num_users=3000, num_items=3000, num_ratings=30_000, seed=7)
       if small else dict(num_users=500_000, num_items=2_200_000,
                          num_ratings=10_000_000, seed=7)), device=dev.type)
btrain, _ = split_ratings(big, 0.2, seed=2)
out["BPRMF minibatch"] = both(create_item_recommender, "BPRMF",
                              "num_factors=40 num_iter=3",
                              posonly_from_ratings(btrain),
                              epoch=(bpr, "bpr_epoch"))
print("PROBE " + json.dumps(out), flush=True)
