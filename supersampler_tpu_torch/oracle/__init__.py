"""The port's scalar oracle: the bit-exact pure-Python sketcher and
comparator that the card's pipeline is held to (the port's copy of
supersampler_tpu/oracle)."""

from supersampler_tpu_torch.oracle.comparator import OracleComparator
from supersampler_tpu_torch.oracle.subsampler import OracleSubsampler

__all__ = ["OracleSubsampler", "OracleComparator"]
