from supersampler_tpu_torch.io.fasta import get_out_name
from supersampler_tpu_torch.io.gzip_exact import write_gzip_exact
from supersampler_tpu_torch.sketch.pipeline import TorchSubsampler, sketch_fof
from supersampler_tpu_torch.sketch.stats import print_stat


def subsample_file(ss, input_path: str, prefix: str) -> str:
    """Run the sketch pipeline and write the gzip sketch file (the
    reference writes zstr level 9, SubSampler.cpp:325-326; the
    container is byte-identical). Returns the output path."""
    out_path = get_out_name(input_path, prefix) + ".gz"
    raw = ss.sketch_file(input_path)
    if raw is not None:
        write_gzip_exact(out_path, raw, level=9)
    ss.subsampled_file = out_path
    return out_path


__all__ = ["TorchSubsampler", "print_stat", "sketch_fof", "subsample_file"]
