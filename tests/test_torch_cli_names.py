"""The port's three CLIs on recommender names, against the JAX
package's CLIs, in process.

A name the framework does not know gives the JAX CLI's line, "Unknown
recommender 'X'. Choose from:" and the list of names, on standard error,
and exit code 1. Every name of the JAX registry resolves in the port:
the eight names ported last get past the name check in each CLI and stop
where the JAX CLI stops without a training file.
"""

import pytest

from mymedialite_tpu.cli import item_recommendation as jax_item
from mymedialite_tpu.cli import rating_based_ranking as jax_ranking
from mymedialite_tpu.cli import rating_prediction as jax_rating
from mymedialite_tpu.models import registry as jax_registry
from mymedialite_tpu_torch.cli import item_recommendation as port_item
from mymedialite_tpu_torch.cli import rating_based_ranking as port_ranking
from mymedialite_tpu_torch.cli import rating_prediction as port_rating
from mymedialite_tpu_torch.models import registry as port_registry

# (port CLI, JAX CLI, a name the port resolves since the last slice)
CLIS = {"rating_prediction": (port_rating, jax_rating, "SocialMF"),
        "item_recommendation": (port_item, jax_item, "BPRSLIM"),
        "rating_based_ranking": (port_ranking, jax_ranking,
                                 "TimeAwareBaseline")}


def _run(main, argv, capsys):
    with pytest.raises(SystemExit) as exc:
        main(argv)
    return exc.value.code, capsys.readouterr().err


@pytest.mark.parametrize("cli", sorted(CLIS))
@pytest.mark.parametrize("case", ["unknown", "not-ported"])
def test_unservable_recommender_name(cli, case, capsys, monkeypatch):
    monkeypatch.setenv("MMLT_COMPILE_CACHE", "0")
    port, jax, newly_ported = CLIS[cli]
    if case == "unknown":
        argv = ["--recommender", "NoSuchModel"]
        code, err = _run(port.main, argv, capsys)
        assert (code, err) == _run(jax.main, argv, capsys)
        assert err.startswith("Unknown recommender 'NoSuchModel'. Choose "
                              "from:\n  ")
    else:
        # the name resolves: both CLIs stop at the missing training file
        argv = ["--recommender", newly_ported]
        code, err = _run(port.main, argv, capsys)
        assert (code, err) == _run(jax.main, argv, capsys)
        assert err.startswith("Please provide either --training-file")
        for name in jax_registry.RATING_PREDICTORS:
            port_registry.create_rating_predictor(name)
        for name in jax_registry.ITEM_RECOMMENDERS:
            port_registry.create_item_recommender(name)
    assert code == 1
