"""``utils.checks.checked`` against the JAX package's ``checked`` (C5).

The JAX wrapper runs the function under checkify's float checks, which
flag a NaN made by any primitive, even one a later ``where`` drops.  The
port's runs it under a ``TorchFunctionMode`` that raises at the torch call
making a NaN its inputs did not hold, then checks the outputs for NaN and
Inf.  On each case both raise, or both return the same values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu80211.utils.checks import checked as jchecked
from tpu80211_torch.utils import checks

NAN = float("nan")
# (name, jnp function, torch function, input, what the port's message names or None)
CASES = [
    ("log_under_where", lambda x: jnp.where(x > 0, jnp.log(x), 0.0),
     lambda x: torch.where(x > 0, torch.log(x), 0.0), [-1.0, 2.0], "nan generated by log"),
    ("sqrt_under_where", lambda x: jnp.where(x > 0, jnp.sqrt(x), 0.0),
     lambda x: torch.where(x > 0, torch.sqrt(x), 0.0), [-1.0, 4.0], "nan generated by sqrt"),
    ("zero_over_zero", lambda x: x / x, lambda x: x / x, [0.0, 1.0], "nan generated by"),
    ("nan_input_carried", lambda x: x * 2, lambda x: x * 2, [NAN, 1.0], "non-finite"),
    ("clean_where", lambda x: jnp.where(x > 0, x * 2, 0.0),
     lambda x: torch.where(x > 0, x * 2, 0.0), [-1.0, 2.0], None),
    ("nan_input_dropped", lambda x: jnp.where(jnp.isnan(x), 0.0, x),
     lambda x: torch.where(torch.isnan(x), 0.0, x), [NAN, 1.0], None),
]


@pytest.mark.parametrize("name,jfn,tfn,x,raises", CASES, ids=[c[0] for c in CASES])
def test_checked_agrees_with_jax(name, jfn, tfn, x, raises):
    if raises is None:
        want = np.asarray(jchecked(jfn)(jnp.asarray(x, jnp.float32)))
        got = checks.checked(tfn)(torch.tensor(x))
        np.testing.assert_array_equal(got.numpy(), want)
        return
    with pytest.raises(Exception, match="nan generated|division by zero"):
        jchecked(jfn)(jnp.asarray(x, jnp.float32))
    with pytest.raises(FloatingPointError, match=raises):
        checks.checked(tfn)(torch.tensor(x))


def test_unchecked_calls_miss_the_dropped_nan():
    """Without the per-call checks (``errors=()``) only the outputs are
    checked, and the NaN that ``where`` drops goes unseen: the seed
    behaviour, kept as an option."""
    x = torch.tensor([-1.0, 2.0])
    out = checks.checked(lambda v: torch.where(v > 0, torch.log(v), 0.0), errors=())(x)
    assert out[0] == 0 and out[1] == pytest.approx(np.log(2.0))


def test_checked_raises_on_inf_outputs_and_unknown_checks():
    with pytest.raises(FloatingPointError, match="non-finite"):
        checks.checked(lambda v: 1.0 / v)(torch.tensor([0.0, 1.0]))
    with pytest.raises(ValueError, match="subset"):
        checks.checked(lambda v: v, errors=("overflow",))


def test_checked_names_the_wrapped_function_and_complex_ops():
    """The message names the wrapped function; complex results are checked."""
    def chain(z):
        return torch.where(z.abs() > 1, z / z.abs(), 0)

    with pytest.raises(FloatingPointError, match="chain: nan generated by"):
        checks.checked(chain)(torch.tensor([0j, 2 + 0j]))
