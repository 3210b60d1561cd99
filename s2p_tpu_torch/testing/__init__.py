"""Test helpers of the port (the port of ``s2p_tpu/testing``'s csv and stub
modules), for the port's own tests."""

from s2p_tpu_torch.testing.csv_util import check_equal, check_exactly_equal, get_exp
from s2p_tpu_torch.testing.stubs import AddEs, StubPolicy, is_binomial_trial_likely

__all__ = ["get_exp", "check_equal", "check_exactly_equal", "StubPolicy", "AddEs",
           "is_binomial_trial_likely"]
