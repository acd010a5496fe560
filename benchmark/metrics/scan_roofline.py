"""scan_roofline: the v1 scan kernel (csrc/scan.cu spsp_scan): its
launches' least times by the published peaks over their device time in
the traced window, %."""

from benchmark.readings import kernel_roofline_pct


def read(run):
    return kernel_roofline_pct(run, "spsp_scan", "scan_kernel(", False)
