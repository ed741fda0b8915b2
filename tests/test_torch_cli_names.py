"""The port's three CLIs on a recommender name they cannot serve, against
the JAX package's CLIs, in process.

A name the framework does not know gives the JAX CLI's line, "Unknown
recommender 'X'. Choose from:" and the list of names, on standard error,
and exit code 1. A name the framework knows but the port has not ported
yet says so, with the same list.
"""

import pytest

from mymedialite_tpu.cli import item_recommendation as jax_item
from mymedialite_tpu.cli import rating_based_ranking as jax_ranking
from mymedialite_tpu.cli import rating_prediction as jax_rating
from mymedialite_tpu_torch.cli import item_recommendation as port_item
from mymedialite_tpu_torch.cli import rating_based_ranking as port_ranking
from mymedialite_tpu_torch.cli import rating_prediction as port_rating

# (port CLI, JAX CLI, a known name that the port has not ported)
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
    port, jax, unported = CLIS[cli]
    if case == "unknown":
        argv = ["--recommender", "NoSuchModel"]
        code, err = _run(port.main, argv, capsys)
        assert (code, err) == _run(jax.main, argv, capsys)
        assert err.startswith("Unknown recommender 'NoSuchModel'. Choose "
                              "from:\n  ")
    else:
        code, err = _run(port.main, ["--recommender", unported], capsys)
        assert err.startswith(f"'{unported}' is not yet ported to "
                              "mymedialite_tpu_torch. Choose from:\n  ")
        assert f"\n  {unported}\n" in err
    assert code == 1
