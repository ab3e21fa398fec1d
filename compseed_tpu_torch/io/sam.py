"""SAM header emission (bwa_print_sam_hdr, bwalib/bwa.c:406-427)."""

from __future__ import annotations

from compseed_tpu_torch.index.fmindex import FMIndex


def sam_header(fm: FMIndex, hdr_line: str | None = None,
               pg_line: str | None = None) -> str:
    out = []
    n_sq = 0
    if hdr_line:
        for ln in hdr_line.split("\n"):
            if ln.startswith("@SQ\t"):
                n_sq += 1
    if n_sq == 0:
        for a in fm.bns.anns:
            out.append(f"@SQ\tSN:{a.name}\tLN:{a.length}")
            out.append("\tAH:*\n" if a.is_alt else "\n")
    if hdr_line:
        out.append(hdr_line + "\n")
    if pg_line:
        out.append(pg_line + "\n")
    return "".join(out)
