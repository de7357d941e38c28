"""Golden end-to-end SAM/PAF equality against reference-binary outputs
(tests/data/README.md). The PR1 acceptance metric is byte-identical
SAM; any divergence is a bug or a documented parity gap."""

import io
import os
import sys

import pytest

DATA = os.path.join(os.path.dirname(__file__), "data")


def _run_cli(args):
    from minialign_jax import cli
    out = io.StringIO()
    old = sys.stdout
    sys.stdout = out
    try:
        rc = cli.main(args)
    finally:
        sys.stdout = old
    assert rc == 0
    return out.getvalue()


def _strip_pg(text):
    return [l for l in text.splitlines() if not l.startswith("@PG")]


@pytest.mark.slow
def test_default_sam_byte_identical():
    got = _run_cli(["-t1", f"{DATA}/tref.fa", f"{DATA}/treads.fq"])
    want = open(f"{DATA}/ref_out.sam").read()
    assert _strip_pg(got) == _strip_pg(want)


@pytest.mark.slow
def test_threaded_pipeline_byte_identical():
    """-t4 engages the source->worker->drain host pipeline (cli._map_block)
    and must produce the exact -t1-schedule bytes (PARITY.md item 8)."""
    got = _run_cli(["-t4", f"{DATA}/tref.fa", f"{DATA}/treads.fq"])
    want = open(f"{DATA}/ref_out.sam").read()
    assert _strip_pg(got) == _strip_pg(want)


@pytest.mark.slow
def test_pacbio_preset_sam_byte_identical():
    got = _run_cli(["-t1", "-xpacbio", f"{DATA}/tref.fa",
                    f"{DATA}/treads.fq"])
    want = open(f"{DATA}/ref_pacbio.sam").read()
    assert _strip_pg(got) == _strip_pg(want)


def _strip_md(lines):
    return ["\t".join(f for f in l.split("\t")
                      if not f.startswith("MD:Z:")) for l in lines]


@pytest.mark.slow
def test_tags_sam_byte_identical():
    """All tag fields byte-identical except MD, where the reference has
    a reverse-strand bug (PARITY.md item 1); MD correctness is covered
    by test_md_truth."""
    got = _run_cli(["-t1", "-TAS,NM,MD,XS,NH,IH", f"{DATA}/tref.fa",
                    f"{DATA}/treads.fq"])
    want = open(f"{DATA}/ref_tags.sam").read()
    got_l, want_l = _strip_pg(got), _strip_pg(want)
    assert _strip_md(got_l) == _strip_md(want_l)
    # forward-strand MD must still match the reference exactly
    for g, w in zip(got_l, want_l):
        if g.startswith("@"):
            continue
        if int(g.split("\t")[1]) & 0x10 == 0:
            assert g == w
    global _TAGS_OUTPUT
    _TAGS_OUTPUT = got


_TAGS_OUTPUT = None


@pytest.mark.slow
def test_md_truth():
    """Our MD must equal an independent CIGAR-walk recomputation for
    every record (both strands)."""
    import re
    got = _TAGS_OUTPUT or _run_cli(
        ["-t1", "-TMD", f"{DATA}/tref.fa", f"{DATA}/treads.fq"])
    ref = "".join(l.strip() for l in open(f"{DATA}/tref.fa")
                  if not l.startswith(">"))
    reads = {}
    ls = open(f"{DATA}/treads.fq").read().splitlines()
    for i in range(0, len(ls), 4):
        reads[ls[i][1:].split()[0]] = ls[i + 1]
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    n_checked = 0
    for line in got.splitlines():
        if line.startswith("@"):
            continue
        rec = line.split("\t")
        flag, pos, cig = int(rec[1]), int(rec[3]), rec[5]
        seq = reads[rec[0]]
        if flag & 16:
            seq = "".join(comp[c] for c in reversed(seq))
        md_field = [f for f in rec if f.startswith("MD:Z:")]
        if not md_field:
            continue
        ri, qi = pos - 1, 0
        md, run = [], 0
        for c, op in re.findall(r"(\d+)([MIDSH])", cig):
            c = int(c)
            if op in "SH":
                qi += c
            elif op == "M":
                for _ in range(c):
                    if ref[ri] == seq[qi]:
                        run += 1
                    else:
                        md.append(str(run))
                        md.append(ref[ri])
                        run = 0
                    ri += 1
                    qi += 1
            elif op == "D":
                md.append(str(run))
                run = 0
                md.append("^" + ref[ri:ri + c])
                ri += c
            else:
                qi += c
        md.append(str(run))
        assert md_field[0][5:] == "".join(md), rec[0]
        n_checked += 1
    assert n_checked == 8


@pytest.mark.slow
def test_qual_sam_byte_identical():
    got = _run_cli(["-t1", "-Q", f"{DATA}/tref.fa", f"{DATA}/treads.fq"])
    want = open(f"{DATA}/ref_qual.sam").read()
    assert _strip_pg(got) == _strip_pg(want)


@pytest.mark.slow
def test_paf_byte_identical():
    got = _run_cli(["-t1", "-Opaf", f"{DATA}/tref.fa",
                    f"{DATA}/treads.fq"])
    want = open(f"{DATA}/ref_out.paf").read()
    assert got == want


@pytest.mark.slow
def test_maf_byte_identical():
    got = _run_cli(["-t1", "-Omaf", f"{DATA}/tref.fa",
                    f"{DATA}/treads.fq"])
    want = open(f"{DATA}/ref_out.maf").read()
    assert got == want


@pytest.mark.slow
def test_blast6_byte_identical():
    got = _run_cli(["-t1", "-Oblast6", f"{DATA}/tref.fa",
                    f"{DATA}/treads.fq"])
    want = open(f"{DATA}/ref_out.b6").read()
    assert got == want


@pytest.mark.slow
def test_ava_paf_byte_identical():
    """All-vs-all driver mode (-X): every positional file is indexed
    and every file is mapped against every index
    (minialign.c:6377-6378). PAF carries no header, so this golden is
    fully byte-exact."""
    got = _run_cli(["-t1", "-X", "-xava", "-Opaf", f"{DATA}/treads.fa",
                    f"{DATA}/treads2.fq"])
    want = open(f"{DATA}/ref_ava.paf").read()
    assert got == want


@pytest.mark.slow
def test_ava_sam_byte_identical():
    """AVA SAM needs -R: the reference ORs MM_AVA (bit 0) into the
    printer tag flags where it aliases the MM_RG bit
    (minialign.c:5679), so -X without -R segfaults the reference on a
    NULL rg_line; with -R both emit the @RG line + RG:Z tags."""
    got = _run_cli(["-t1", "-X", "-xava", "-R", "@RG\\tID:ava",
                    f"{DATA}/treads.fa", f"{DATA}/treads2.fq"])
    want = open(f"{DATA}/ref_ava_rg.sam").read()
    assert _strip_pg(got) == _strip_pg(want)


@pytest.mark.slow
def test_multiblock_index_byte_identical(tmp_path):
    """A prebuilt index holding multiple blocks maps the query against
    each block in sequence, re-printing the header per block
    (minialign.c:6414-6436)."""
    mai = str(tmp_path / "two.mai")
    rc = __import__("minialign_jax.cli", fromlist=["main"]).main(
        ["-t1", "-d", mai, f"{DATA}/tref.fa", f"{DATA}/tref.fa"])
    assert rc == 0
    got = _run_cli(["-t1", mai, f"{DATA}/treads.fq"])
    want = open(f"{DATA}/ref_twoblock.sam").read()
    assert _strip_pg(got) == _strip_pg(want)


@pytest.mark.slow
def test_circular_sam_byte_identical():
    """Circular reference (-c NAME): origin-spanning alignments split
    at the wrap into primary + supplementary (0x800) records
    (mm_sketch_cap / mm_circularize / rtp re-feed)."""
    got = _run_cli(["-t1", "-cplasmid", f"{DATA}/cplas.fa",
                    f"{DATA}/creads.fq"])
    want = open(f"{DATA}/ref_circ.sam").read()
    assert _strip_pg(got) == _strip_pg(want)


@pytest.mark.slow
def test_circular_paf_byte_identical():
    got = _run_cli(["-t1", "-Opaf", "-cplasmid", f"{DATA}/cplas.fa",
                    f"{DATA}/creads.fq"])
    want = open(f"{DATA}/ref_circ.paf").read()
    assert got == want


@pytest.mark.slow
def test_circular_tags_sam_byte_identical():
    """All tags on circular data, incl. SA across origin-split
    segments (raw x16 mapq in SA, minialign.c:5230). MD on reverse
    strand carries the reference bug (PARITY.md item 1) — stripped."""
    got = _run_cli(["-t1", "-cplasmid", "-TAS,NM,MD,SA,XS,NH,IH",
                    f"{DATA}/cplas.fa", f"{DATA}/creads.fq"])
    want = open(f"{DATA}/ref_circ_tags.sam").read()
    got_l, want_l = _strip_pg(got), _strip_pg(want)
    assert _strip_md(got_l) == _strip_md(want_l)
    for g, w in zip(got_l, want_l):
        if not g.startswith("@") and int(g.split("\t")[1]) & 0x10 == 0:
            assert g == w


@pytest.mark.slow
def test_bam_input_byte_identical():
    """BAM query input (bseq_read_bam): 4-bit decode with non-ACGT ->
    A, flag 0x10 records restored to original orientation, 0x900
    records skipped. Goldens were generated with a trailing-u32 EOF
    quirk file because the reference's BAM loop never terminates on a
    well-formed BAM (PARITY.md item 7)."""
    got = _run_cli(["-t1", f"{DATA}/tref.fa", f"{DATA}/treads.bam"])
    want = open(f"{DATA}/ref_bam.sam").read()
    assert _strip_pg(got) == _strip_pg(want)
    got_q = _run_cli(["-t1", "-Q", f"{DATA}/tref.fa",
                      f"{DATA}/treads.bam"])
    want_q = open(f"{DATA}/ref_bam_q.sam").read()
    assert _strip_pg(got_q) == _strip_pg(want_q)


@pytest.mark.slow
def test_bam_tag_passthrough():
    """-T-listed BAM aux tags are preserved onto the primary record
    (bseq_save_tags/mm_restore_sam_tags intent; the reference binary
    segfaults on any -T with BAM input, PARITY.md item 7), including
    the B-array render quirk (no subtype char, trailing commas)."""
    got = _run_cli(["-t1", "-Q", "-TRG,XB", f"{DATA}/tref.fa",
                    f"{DATA}/treads.bam"])
    assert "RG:Z:grp1" in got
    assert "XB:B:-1,2,300," in got


@pytest.mark.slow
def test_ont_preset_sam_byte_identical():
    got = _run_cli(["-t1", "-xont.r9.4.1d", f"{DATA}/tref.fa",
                    f"{DATA}/treads.fq"])
    want = open(f"{DATA}/ref_ont.sam").read()
    assert _strip_pg(got) == _strip_pg(want)


@pytest.mark.slow
def test_config_file_preset(tmp_path):
    """Unknown preset names fall back to loading a config file whose
    contents parse as a command line (mm_opt_load_conf,
    minialign.c:5817-5840)."""
    # note: -x splits its argument on '.' before the file fallback
    # (mm_opt_preset's mm_split_foreach), so config files need
    # dot-free paths — a reference quirk kept as-is
    conf = tmp_path / "myconf"
    conf.write_text("-k15 -w10 -a2\n-b4 -p4 -q2 -r3,3 -Y50 -s50 -m0.3\n")
    got = _run_cli(["-t1", "-x", str(conf), f"{DATA}/tref.fa",
                    f"{DATA}/treads.fq"])
    want = open(f"{DATA}/ref_pacbio.sam").read()
    assert _strip_pg(got) == _strip_pg(want)


@pytest.mark.slow
def test_matrix_modifier_sam_byte_identical():
    """BASELINE config 3: custom scoring with a -e score-matrix
    modifier (non-uniform matrix -> the 16-term substitution select
    chain in the fill kernels)."""
    got = _run_cli(["-t1", "-a2", "-b5", "-p5", "-q1", "-r3,3",
                    "-eGA+3", f"{DATA}/tref.fa", f"{DATA}/treads.fq"])
    want = open(f"{DATA}/ref_emod.sam").read()
    assert _strip_pg(got) == _strip_pg(want)


@pytest.mark.slow
def test_ont1dsq_circular_sa_md():
    """BASELINE config 4: ONT 1Dsq preset + circular reference +
    SA/MD tags (MD on reverse strand carries the reference bug,
    PARITY.md item 1 — stripped)."""
    got = _run_cli(["-t1", "-xont.1dsq", "-cplasmid", "-TSA,MD",
                    f"{DATA}/cplas.fa", f"{DATA}/creads.fq"])
    want = open(f"{DATA}/ref_ont1dsq_circ.sam").read()
    assert _strip_md(_strip_pg(got)) == _strip_md(_strip_pg(want))


@pytest.mark.slow
def test_multichrom_sam_byte_identical():
    """Multi-sequence reference: per-rid chaining boundaries, multiple
    @SQ lines, cross-chromosome secondary suppression."""
    got = _run_cli(["-t1", f"{DATA}/mref.fa", f"{DATA}/mreads.fq"])
    want = open(f"{DATA}/ref_multi.sam").read()
    assert _strip_pg(got) == _strip_pg(want)


@pytest.mark.slow
def test_repetitive_sam_byte_identical():
    """Tandem-repeat reference: occurrence-tier rescue rounds
    (mm_seed round > 0), many secondary records, prune/supp boundaries
    under heavy multi-mapping."""
    got = _run_cli(["-t1", "-xpacbio", f"{DATA}/repref.fa",
                    f"{DATA}/repreads.fq"])
    want = open(f"{DATA}/ref_rep.sam").read()
    assert _strip_pg(got) == _strip_pg(want)


@pytest.mark.slow
def test_traceback_tie_sam_byte_identical():
    """Exact-score tie between a diagonal mismatch and a gf-gap +
    affine-run extension: requires gaba's trace_core state machine
    (d_head/d_tail dispatch, folded e/f bits) AND the printers'
    reverse path parse (gaba_dump_cigar_reverse re-association).
    Found by tests/tools/fuzz_parity.py (seed 2, case 5)."""
    got = _run_cli(["-t1", "-xpacbio.ccs", f"{DATA}/tieref.fa",
                    f"{DATA}/tiereads.fq"])
    want = open(f"{DATA}/ref_tie.sam").read()
    assert _strip_pg(got) == _strip_pg(want)


@pytest.mark.slow
def test_xdrop_rolling_peak_byte_identical():
    """Low-identity secondary alignment whose center lane dips more
    than xdrop below the global max while staying within xdrop of its
    own rolling peak: requires gaba's saturating per-lane drop
    accumulator (gaba.c:1650/1738/3823), not a global-max drop test.
    Found by tests/tools/fuzz_parity.py (seed 3, case 7)."""
    got = _run_cli(["-t1", "-a2", "-b1", "-p4", "-q2", "-TAS,NM,XS,NH",
                    f"{DATA}/xdref.fa", f"{DATA}/xdreads.fq"])
    want = open(f"{DATA}/ref_xdrop.sam").read()
    got_l, want_l = _strip_pg(got), _strip_pg(want)
    assert _strip_md(got_l) == _strip_md(want_l)


@pytest.mark.slow
def test_circular_maf_byte_identical():
    """Origin-wrapping alignments in MAF: one block per path segment
    (minialign.c:5505-5507) with walker-token segment splits (v pops
    don't test the a-side boundary). Found by the fuzzer (seed 20)."""
    got = _run_cli(["-t1", "-a3", "-b4", "-p0", "-q2", "-m0.5",
                    "-cc0", "-Omaf", f"{DATA}/cmref.fa",
                    f"{DATA}/cmreads.fq"])
    want = open(f"{DATA}/ref_circmaf.maf").read()
    assert got == want


@pytest.mark.slow
def test_circular_split_sam_byte_identical():
    """Same inputs through the SAM path (segment splits shared with
    the MAF printer)."""
    got = _run_cli(["-t1", "-a3", "-b4", "-p0", "-q2", "-m0.5",
                    "-cc0", f"{DATA}/cmref.fa", f"{DATA}/cmreads.fq"])
    want = open(f"{DATA}/ref_circsplit.sam").read()
    assert _strip_pg(got) == _strip_pg(want)


@pytest.mark.slow
def test_ksort_tie_order_byte_identical():
    """Dense k10/w3 seeds over a repeat: the greedy chain structure
    depends on ksort's exact (unstable) equal-key radix permutation of
    the seed sort (minialign.c:203+3535). A stable sort splits one
    chain in two and leaks an extra secondary record. Found by the
    fuzzer (seed 32); exercises minialign_jax/ksort.py end to end."""
    got = _run_cli(["-t1", "-a3", "-b2", "-p5", "-q2", "-r3,3",
                    "-s59", "-m0.2", "-k10", "-w3",
                    f"{DATA}/ksref.fa", f"{DATA}/ksreads.fq"])
    want = open(f"{DATA}/ref_ksort.sam").read()
    got_l, want_l = _strip_pg(got), _strip_pg(want)
    assert _strip_md(got_l) == _strip_md(want_l)
