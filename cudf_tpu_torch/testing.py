"""cudf_tpu_torch.testing: public test utilities (cudf.testing's role)."""

from cudf_tpu_torch.utils.testing import assert_eq, make_random_frame

__all__ = ["assert_eq", "make_random_frame"]
