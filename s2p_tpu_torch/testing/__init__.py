"""Test helpers of the port (the port of ``s2p_tpu/testing``: csv, stubs
and golden-tensor traces), and the workers of its multi-process tests."""

from s2p_tpu_torch.testing.csv_util import check_equal, check_exactly_equal, get_exp
from s2p_tpu_torch.testing.debug_util import TensorTrace, load_tensor, save_tensor
from s2p_tpu_torch.testing.stubs import AddEs, StubPolicy, is_binomial_trial_likely

__all__ = ["get_exp", "check_equal", "check_exactly_equal", "StubPolicy", "AddEs",
           "is_binomial_trial_likely", "save_tensor", "load_tensor", "TensorTrace"]
