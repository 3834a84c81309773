"""LVQ-side CLI tools: the lvqtrain multi-binary (lvq1/lvq2/lvq3/olvq1),
eveninit/propinit, balance, the evaluators (accuracy/classify/knntest/
mcnemar/cmatr), class statistics (mindist/stddev), and the dataset
editors (pick/extract/setlabel/showlabs/elimin).

Flag surfaces and message/exit behavior mirror the reference programs
one-to-one (lvqtrain.c, eveninit.c, balance.c, accuracy.c, classify.c,
knntest.c, mcnemar.c, cmatr.c, mindist.c, stddev.c, pick.c, extract.c,
setlabel.c, showlabs.c, elimin.c).

The port's copy of som_lvq_pak_tpu/cli/cmds_lvq.py.  Each tool takes the
device of its `-fast` route (`device`, from `cli.main`); without `-fast` a
tool runs on the host and writes the JAX CLI's bytes.  The port's models
default to their device paths, so every call that the JAX CLI leaves at
its package's parity default passes the parity mode by name here:
accuracy, classify and cmatr `parity=True`, the lvqtrain family
`mode="parity"`."""

from __future__ import annotations

import sys

import numpy as np

from ..data.io import read_alpha_file, write_alpha_file, write_data
from ..data.labels import GLOBAL_LABELS
from ..models import eval as ev
from ..models import lvq, tools
from .common import (
    get_alpha_type,
    get_rand,
    get_snapshot_opts,
    load_data,
    load_or_stream,
    require_same_dim,
    save_codes,
)
from .params import ALWAYS, OPTION, OPTION2, ArgScanner, err, ifverbose, selfuncs


def _invalidate(out_code_file: str) -> None:
    """invalidate_alphafile incl. its verbose message (datafile.c:1088-1108)."""
    from ..data.io import _alpha_basename
    import os

    path = _alpha_basename(out_code_file)
    if os.path.exists(path):
        if ifverbose(1):
            sys.stdout.write("Removing the learning rate file %s\n" % path)
        os.remove(path)


# ---------------------------------------------------------------------------
# lvqtrain / lvq1 / lvq2 / lvq3 / olvq1  (lvqtrain.c)
# ---------------------------------------------------------------------------

LVQ_TYPES = ("lvq1", "lvq2", "lvq3", "olvq1")


def cmd_lvqtrain(scanner: ArgScanner, progname: str, device) -> int:
    lvqtype = progname if progname in LVQ_TYPES else None
    typename = scanner.get("-type", OPTION)
    if typename is not None:
        lvqtype = typename if typename in LVQ_TYPES else None
    if lvqtype is None:
        err("Unknown LVQ type %s" % (typename or progname))

    in_data_file = scanner.get("-din", ALWAYS)
    in_code_file = scanner.get("-cin", ALWAYS)
    out_code_file = scanner.get("-cout", ALWAYS)
    rlen = scanner.get_int("-rlen", 0, ALWAYS)
    rng, random_order = get_rand(scanner)
    alpha_type = get_alpha_type(scanner)
    buffer = scanner.get_int("-buffer", 0, OPTION)
    snapshot = get_snapshot_opts(scanner, out_code_file, rlen)

    # per-type required flags (lvqtrain.c:144-162)
    if lvqtype == "olvq1":
        alpha = scanner.get_float("-alpha", 0.0, OPTION)
        winlen = epsilon = None
    elif lvqtype == "lvq2":
        alpha = scanner.get_float("-alpha", 0.0, ALWAYS)
        winlen = scanner.get_float("-win", 0.0, ALWAYS)
        epsilon = None
    elif lvqtype == "lvq3":
        alpha = scanner.get_float("-alpha", 0.0, ALWAYS)
        epsilon = scanner.get_float("-epsilon", 0.0, ALWAYS)
        winlen = scanner.get_float("-win", 0.0, ALWAYS)
    else:
        alpha = scanner.get_float("-alpha", 0.0, ALWAYS)
        winlen = epsilon = None

    # -fast (extension): minibatch training through the LVQ trainers'
    # device path (quality contract; -batch sets the minibatch)
    fast = scanner.get("-fast", OPTION2) is not None
    batch = scanner.get_int("-batch", 1024, OPTION)

    data = load_or_stream(in_data_file, buffer)
    codes = load_data(in_code_file, "codes")
    require_same_dim(data, codes)

    if fast:
        from ..models.trainer import LVQTrainer, OLVQ1Trainer

        if snapshot is not None:
            snapshot.close()  # -fast uses trainer checkpoints instead
        feed = (data.chunks(laps=None) if buffer > 0 else data)
        if lvqtype == "olvq1":
            tr = OLVQ1Trainer(codes, batch_size=max(1, batch),
                              alpha=(alpha if alpha > 0.0 else 0.3), device=device)
            out = tr.fit(feed, rlen)
        else:
            tr = LVQTrainer(codes, algorithm=lvqtype,
                            batch_size=max(1, batch),
                            winlen=(winlen if winlen is not None else 0.3),
                            epsilon=(epsilon if epsilon is not None
                                     else 0.1), device=device)
            out = tr.fit(feed, rlen, alpha, alpha_type=alpha_type)
        if ifverbose(2):
            sys.stdout.write(
                "Codebook entries are saved to file %s\n" % out_code_file)
        write_data(out, out_code_file)
        _invalidate(out_code_file)
        return 0

    progress = None
    if ifverbose(1) and sys.stderr.isatty():
        from ..utils.progress import Mprint

        progress = Mprint()
    try:
        if lvqtype == "lvq1":
            out = lvq.lvq1_train(
                codes, data, rlen, alpha, alpha_type=alpha_type,
                random_order=random_order, rng=rng, mode="parity",
                snapshot=snapshot, progress=progress, buffer=buffer,
            )
        elif lvqtype == "olvq1":
            init_alphas = None
            if alpha == 0.0:
                init_alphas = read_alpha_file(in_code_file, codes.n)
            out, alphas = lvq.olvq1_train(
                codes, data, rlen, alpha, init_alphas=init_alphas,
                random_order=random_order, rng=rng, mode="parity",
                return_alphas=True, snapshot=snapshot, progress=progress,
                buffer=buffer,
            )
            write_alpha_file(out_code_file, alphas)
        elif lvqtype == "lvq2":
            out = lvq.lvq2_train(
                codes, data, rlen, alpha, winlen, alpha_type=alpha_type,
                random_order=random_order, rng=rng, mode="parity",
                snapshot=snapshot, progress=progress, buffer=buffer,
            )
        else:
            out = lvq.lvq3_train(
                codes, data, rlen, alpha, winlen, epsilon,
                alpha_type=alpha_type, random_order=random_order, rng=rng,
                mode="parity", snapshot=snapshot, progress=progress,
                buffer=buffer,
            )
    finally:
        if snapshot is not None:
            snapshot.close()

    if ifverbose(2):
        sys.stdout.write("Codebook entries are saved to file %s\n" % out_code_file)
    write_data(out, out_code_file)
    _invalidate(out_code_file)
    return 0


# ---------------------------------------------------------------------------
# eveninit / propinit  (eveninit.c)
# ---------------------------------------------------------------------------

def cmd_eveninit(scanner: ArgScanner, progname: str, device) -> int:
    prop = 1 if progname == "propinit" else (0 if progname == "eveninit" else -1)
    pname = scanner.get("-type", ALWAYS if prop < 0 else OPTION)
    if pname is not None:
        # reference accepts "propinit"/"eveninit" case-insensitively and
        # silently ignores other values (eveninit.c:186-199)
        if pname.lower() == "propinit":
            prop = 1
        elif pname.lower() == "eveninit":
            prop = 0
    if prop < 0:
        err("unknown init type")
    in_data_file = scanner.get("-din", ALWAYS)
    out_code_file = scanner.get("-cout", ALWAYS)
    noc = scanner.get_int("-noc", 0, ALWAYS)
    knn = scanner.get_int("-knn", 5, OPTION)
    # -fast (extension): device dist-matmul self-kNN for huge data files
    # (identical tie order; f32-matmul accumulation, not byte parity)
    mode = "fast" if scanner.get("-fast", OPTION2) is not None else "parity"
    rng, _ = get_rand(scanner)

    data = load_data(in_data_file, "data")
    try:
        codes = lvq.eveninit(data, noc, knn=knn, proportional=bool(prop),
                             mode=mode, device=device)
    except ValueError as e:
        err("Failed to initialize codes: %s" % e)
    save_codes(codes, out_code_file)
    _invalidate(out_code_file)
    return 0


# ---------------------------------------------------------------------------
# balance  (balance.c)
# ---------------------------------------------------------------------------

def cmd_balance(scanner: ArgScanner, progname: str, device) -> int:
    selfuncs(scanner)
    in_data_file = scanner.get("-din", ALWAYS)
    in_code_file = scanner.get("-cin", ALWAYS)
    out_code_file = scanner.get("-cout", ALWAYS)
    knn = scanner.get_int("-knn", 5, OPTION)
    get_rand(scanner)

    data = load_data(in_data_file, "data")
    codes = load_data(in_code_file, "codes")
    if data.dim != codes.dim:
        err("Data and codes have different dimensions")

    report = None
    if ifverbose(1):
        report = lambda line: sys.stdout.write(line + "\n")
    out = lvq.balance(codes, data, knn=knn, alpha_file_out=out_code_file, report=report)
    save_codes(out, out_code_file)
    return 0


# ---------------------------------------------------------------------------
# accuracy  (accuracy.c)
# ---------------------------------------------------------------------------

def cmd_accuracy(scanner: ArgScanner, progname: str, device) -> int:
    selfuncs(scanner)
    in_data_file = scanner.get("-din", ALWAYS)
    in_code_file = scanner.get("-cin", ALWAYS)
    buffer = scanner.get_int("-buffer", 0, OPTION)
    cfout = scanner.get("-cfout", OPTION)

    data = load_or_stream(in_data_file, buffer)
    codes = load_data(in_code_file, "codes")
    if data.dim != codes.dim:
        err("Data and codebook vectors have different dimensions")
    if cfout is not None and ifverbose(2):
        sys.stderr.write("Classifications are saved to file %s\n" % cfout)

    pct, report, ok = ev.accuracy(data, codes, parity=True)
    if cfout is not None:
        with open(cfout, "w") as f:
            for o in ok:
                f.write("1\n" if o else "0\n")
    sys.stdout.write(report)
    return 0


# ---------------------------------------------------------------------------
# classify  (classify.c)
# ---------------------------------------------------------------------------

def cmd_classify(scanner: ArgScanner, progname: str, device) -> int:
    selfuncs(scanner)
    in_data_file = scanner.get("-din", ALWAYS)
    in_code_file = scanner.get("-cin", ALWAYS)
    cfout = scanner.get("-cfout", OPTION)
    buffer = scanner.get_int("-buffer", 0, OPTION)
    out_data_file = scanner.get("-dout", ALWAYS)

    if buffer > 0:
        from ..data.io import write_data_chunks
        from ..data.streaming import StreamingReader

        data = StreamingReader(in_data_file, buffer, skip_empty=False)
        codes = load_data(in_code_file, "codes")
        if data.dim != codes.dim:
            err("Data and codebook vectors have different dimensions")
        cf = open(cfout, "w") if cfout is not None else None
        try:
            def chunks():
                for c in data.chunks(laps=1):
                    out_c, names = ev.classify(c, codes, parity=True)
                    if cf is not None:
                        for name in names:
                            cf.write("%s\n" % name)
                    yield out_c
            import numpy as _np

            from ..data.dataset import Dataset as _DS

            meta = _DS(points=_np.zeros((0, data.dim), _np.float32),
                       topol=data.topol, neigh=data.neigh,
                       xdim=data.xdim, ydim=data.ydim)
            if ifverbose(2):
                sys.stderr.write(
                    "Data entries are saved to file %s\n" % out_data_file)
            write_data_chunks(chunks(), out_data_file, meta=meta)
        finally:
            if cf is not None:
                cf.close()
        return 0
    data = load_data(in_data_file, "data", skip_empty=False)
    codes = load_data(in_code_file, "codes")
    if data.dim != codes.dim:
        err("Data and codebook vectors have different dimensions")

    out, names = ev.classify(data, codes, parity=True)
    if cfout is not None:
        with open(cfout, "w") as f:
            for name in names:
                f.write("%s\n" % name)
    if ifverbose(2):
        sys.stderr.write("Data entries are saved to file %s\n" % out_data_file)
    write_data(out, out_data_file)
    return 0


# ---------------------------------------------------------------------------
# knntest  (knntest.c)
# ---------------------------------------------------------------------------

def cmd_knntest(scanner: ArgScanner, progname: str, device) -> int:
    selfuncs(scanner)
    in_data_file = scanner.get("-din", ALWAYS)
    in_code_file = scanner.get("-cin", ALWAYS)
    knn = scanner.get_int("-knn", 5, OPTION)
    buffer = scanner.get_int("-buffer", 0, OPTION)
    mode = "fast" if scanner.get("-fast", OPTION2) is not None else "parity"

    data = load_or_stream(in_data_file, buffer)
    codes = load_data(in_code_file, "codes")
    if data.dim != codes.dim:
        err("Data and codebook vectors have different dimensions")

    _, report = ev.knn_accuracy(data, codes, knn=knn, mode=mode, device=device)
    sys.stdout.write(report)
    return 0


# ---------------------------------------------------------------------------
# mcnemar  (mcnemar.c) — positional args, report to stderr
# ---------------------------------------------------------------------------

# byte-identical to the reference's usage string (mcnemar.c:46-49),
# printed to stderr on wrong argc with exit 1 (mcnemar.c:60-63)
MCNEMAR_USAGE = (
    "\nUsage: mcnemar classification_file1 classification_file2\n"
    ' You must first run "accuracy" with option "-cfout classification_file"\n'
    " to create the files containing classification information.\n"
)


def cmd_mcnemar(scanner: ArgScanner, progname: str, device) -> int:
    argv = scanner.argv
    if len(argv) != 2:
        sys.stderr.write(MCNEMAR_USAGE)
        return 1
    streams = []
    for name in argv:
        try:
            with open(name) as f:
                streams.append([int(x) for x in f.read().split()])
        except OSError:
            sys.stderr.write("\nCannot open %s\n" % name)
            return 1
        except ValueError:
            sys.stderr.write("\nFiles contain other than 0's and 1's.\n")
            return 1
    try:
        report = ev.mcnemar(np.asarray(streams[0]), np.asarray(streams[1]))
    except ValueError as e:
        sys.stderr.write("\n%s\n" % ("ERROR: " + str(e) if "Unequal" in str(e) else str(e)))
        return 1
    sys.stderr.write(report)
    return 0


# ---------------------------------------------------------------------------
# cmatr  (cmatr.c)
# ---------------------------------------------------------------------------

def cmd_cmatr(scanner: ArgScanner, progname: str, device) -> int:
    in_data_file = scanner.get("-din", ALWAYS)
    in_code_file = scanner.get("-cin", ALWAYS)
    buffer = scanner.get_int("-buffer", 0, OPTION)
    cfout = scanner.get("-cfout", OPTION)

    data = load_or_stream(in_data_file, buffer)
    codes = load_data(in_code_file, "codes")
    if data.dim != codes.dim:
        err("Data and codebook vectors have different dimensions")

    report, _, ok = ev.confusion_matrix(data, codes, parity=True)
    if cfout is not None:
        with open(cfout, "w") as f:
            for o in ok:
                f.write("1\n" if o else "0\n")
    sys.stdout.write(report)
    return 0


# ---------------------------------------------------------------------------
# mindist / stddev  (mindist.c, stddev.c)
# ---------------------------------------------------------------------------

def cmd_mindist(scanner: ArgScanner, progname: str, device) -> int:
    in_code_file = scanner.get("-cin", ALWAYS)
    in_data_file = scanner.get("-din", OPTION)

    codes = load_data(in_code_file, "codes")
    data = load_data(in_data_file, "data") if in_data_file is not None else None
    sys.stdout.write(tools.mindist_report(codes, data))
    return 0


def cmd_stddev(scanner: ArgScanner, progname: str, device) -> int:
    in_data_file = scanner.get("-din", ALWAYS)
    data = load_data(in_data_file, "data")
    sys.stdout.write(tools.stddev_report(data))
    return 0


# ---------------------------------------------------------------------------
# pick / extract / setlabel / showlabs / elimin
# ---------------------------------------------------------------------------

def cmd_pick(scanner: ArgScanner, progname: str, device) -> int:
    in_data_file = scanner.get("-din", ALWAYS)
    out_code_file = scanner.get("-cout", ALWAYS)
    num = scanner.get_int("-noc", 1, ALWAYS)
    data = load_data(in_data_file, "data")
    codes = lvq.pick_codes(num, data)
    save_codes(codes, out_code_file)
    _invalidate(out_code_file)
    return 0


def cmd_extract(scanner: ArgScanner, progname: str, device) -> int:
    in_data_file = scanner.get("-din", ALWAYS)
    out_code_file = scanner.get("-cout", ALWAYS)
    label_s = scanner.get("-label", ALWAYS)
    data = load_data(in_data_file, "data")
    if ifverbose(2):
        sys.stderr.write("Codes %s are extracted\n" % label_s)
    label = GLOBAL_LABELS.to_index(label_s)
    codes = tools.extract(data, label)
    save_codes(codes, out_code_file)
    _invalidate(out_code_file)
    return 0


def cmd_setlabel(scanner: ArgScanner, progname: str, device) -> int:
    selfuncs(scanner)
    in_data_file = scanner.get("-din", ALWAYS)
    in_code_file = scanner.get("-cin", ALWAYS)
    out_code_file = scanner.get("-cout", ALWAYS)
    knn = scanner.get_int("-knn", 5, OPTION)
    buffer = scanner.get_int("-buffer", 0, OPTION)
    mode = "fast" if scanner.get("-fast", OPTION2) is not None else "parity"

    data = load_or_stream(in_data_file, buffer)
    codes = load_data(in_code_file, "codes")
    if data.dim != codes.dim:
        err("Data and codebook vectors have different dimensions")
    out = tools.setlabel(codes, data, knn=knn, mode=mode, device=device)
    save_codes(out, out_code_file)
    return 0


def cmd_showlabs(scanner: ArgScanner, progname: str, device) -> int:
    in_code_file = scanner.get("-cin", ALWAYS)
    codes = load_data(in_code_file, "codes")
    sys.stdout.write(tools.showlabs(codes))
    return 0


def cmd_elimin(scanner: ArgScanner, progname: str, device) -> int:
    in_data_file = scanner.get("-din", ALWAYS)
    out_code_file = scanner.get("-cout", ALWAYS)
    knn = scanner.get_int("-knn", 5, OPTION)
    mode = "fast" if scanner.get("-fast", OPTION2) is not None else "parity"
    data = load_data(in_data_file, "data")
    out = tools.elimin(data, knn=knn, mode=mode, device=device)
    save_codes(out, out_code_file)
    _invalidate(out_code_file)
    return 0
