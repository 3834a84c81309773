"""SOM-side CLI tools: mapinit/randinit/lininit, vsom, qerror, vcal,
visual and the multi-trial vfind driver.

Flag surfaces and messages mirror mapinit.c, vsom.c, qerror.c, vcal.c,
visual.c and vfind.c one-to-one.

The port's copy of som_lvq_pak_tpu/cli/cmds_som.py.  Each tool takes the
device of its `-fast` route (`device`, from `cli.main`): `vsom -fast` is
`SOMTrainer(device=)` (the JAX CLI's `use_pallas=True`), `qerror -fast`
the fast `find_qerror`/`find_qerror2`, `vfind -fast` `vfind_trials`.
Without `-fast` a tool runs on the host and writes the JAX CLI's bytes;
the port's `som_train`, `find_qerror` and `find_qerror2` default to their
device paths, so vsom and vfind pass `mode="parity"` by name."""

from __future__ import annotations

import sys

import numpy as np

from ..data.dataset import NEIGH_IDS, Neighborhood, TOPOL_IDS, Topology
from ..data.io import write_data
from ..models import som, tools
from ..utils.rng import CRandom
from .common import (
    get_alpha_type,
    get_rand,
    get_snapshot_opts,
    load_data,
    load_or_stream,
    require_map,
    require_same_dim,
    save_codes,
)
from .params import ALWAYS, OPTION, OPTION2, ArgScanner, err, ifverbose, selfuncs


def _topol(s: str) -> Topology:
    t = TOPOL_IDS.get(s, Topology.UNKNOWN)
    return t


def _neigh(s: str) -> Neighborhood:
    return NEIGH_IDS.get(s, Neighborhood.UNKNOWN)


# ---------------------------------------------------------------------------
# mapinit / randinit / lininit  (mapinit.c)
# ---------------------------------------------------------------------------

def cmd_mapinit(scanner: ArgScanner, progname: str, device) -> int:
    init_type = {"lininit": "lin", "randinit": "rand"}.get(progname)

    in_data_file = scanner.get("-din", ALWAYS)
    out_code_file = scanner.get("-cout", ALWAYS)
    randomize = scanner.get_int("-rand", 0, OPTION)
    scanner.get_int("-buffer", 0, OPTION)

    s = scanner.get("-topol", ALWAYS)
    topol = _topol(s)
    if topol == Topology.UNKNOWN:
        err("Unknown topology type %s" % s)
    s = scanner.get("-neigh", ALWAYS)
    neigh = _neigh(s)
    if neigh == Neighborhood.UNKNOWN:
        err("Unknown neighborhood type %s" % s)
    xdim = scanner.get_int("-xdim", 0, ALWAYS)
    ydim = scanner.get_int("-ydim", 0, ALWAYS)
    s = scanner.get("-init", OPTION)
    if s in ("lin", "rand"):
        init_type = s
    if scanner.parameters_left():
        sys.stderr.write("Extra parameters in command line ignored\n")
    if init_type is None:
        err("Unknown initialization type %s" % (s or progname))
    if xdim * ydim <= 0 or xdim < 0:
        err("Dimensions of map (%d %d) are incorrect" % (xdim, ydim))

    data = load_data(in_data_file, "data")
    rng = CRandom()
    rng.init_random(randomize)
    if init_type == "rand":
        if ifverbose(2):
            sys.stderr.write("initializing codes (random)\n")
        codes = som.randinit(data, topol, neigh, xdim, ydim, rng)
    else:
        if ifverbose(2):
            sys.stderr.write("initializing codes (linear)\n")
        codes = som.lininit(data, topol, neigh, xdim, ydim, rng)

    if ifverbose(2):
        sys.stderr.write("Codebook entries are saved to file %s\n" % out_code_file)
    write_data(codes, out_code_file, comments="# random seed: %d\n" % randomize)
    return 0


# ---------------------------------------------------------------------------
# vsom  (vsom.c)
# ---------------------------------------------------------------------------

def cmd_vsom(scanner: ArgScanner, progname: str, device) -> int:
    selfuncs(scanner)
    in_data_file = scanner.get("-din", ALWAYS)
    in_code_file = scanner.get("-cin", ALWAYS)
    out_code_file = scanner.get("-cout", ALWAYS)
    rlen = scanner.get_int("-rlen", 0, ALWAYS)
    alpha = scanner.get_float("-alpha", 0.0, ALWAYS)
    radius = scanner.get_float("-radius", 0.0, ALWAYS)
    rng, random_order = get_rand(scanner)
    fixed = scanner.get("-fixed", OPTION2) is not None
    weights = scanner.get("-weights", OPTION2) is not None
    buffer = scanner.get_int("-buffer", 0, OPTION)
    # -fast (extension): minibatch training through SOMTrainer's fused
    # step on the card (quality contract, not the C byte contract; batch
    # size via -batch, default 1024)
    fast = scanner.get("-fast", OPTION2) is not None
    batch = scanner.get_int("-batch", 1024, OPTION)
    # -bf16stream (extension, -fast only): ship streamed input batches
    # host->device in bfloat16 — halves the transfer bytes of a
    # copy-bound ingest (SOMTrainer stream_bf16;
    # quality-gated input quantization, not bit parity)
    bf16stream = scanner.get("-bf16stream", OPTION2) is not None
    if bf16stream and not (fast and buffer > 0):
        sys.stderr.write(
            "vsom: -bf16stream only affects the streamed fast path "
            "(-fast with -buffer N); ignored\n")
        bf16stream = False
    alpha_type = get_alpha_type(scanner)
    snapshot = get_snapshot_opts(scanner, out_code_file, rlen)

    if fast:
        from ..models.trainer import SOMTrainer

        codes = load_data(in_code_file, "codes")
        require_map(codes, in_code_file)
        if snapshot is not None:
            if ifverbose(1):
                sys.stderr.write(
                    "vsom: -fast uses trainer checkpoints, not snapshots\n")
            snapshot.close()
        tr = SOMTrainer(codes, batch_size=max(1, batch), device=device,
                        seed=rng.state % (1 << 31),
                        stream_bf16=bf16stream)
        if buffer > 0:
            from ..data.streaming import StreamingReader

            reader = StreamingReader(in_data_file, buffer)
            require_same_dim(reader, codes)
            out = tr.fit(reader.chunks(laps=None), rlen, alpha, radius,
                         alpha_type=alpha_type, use_weights=weights,
                         use_fixed=fixed)
        else:
            data = load_data(in_data_file, "data")
            require_same_dim(data, codes)
            out = tr.fit(data, rlen, alpha, radius, alpha_type=alpha_type,
                         use_weights=weights, use_fixed=fixed)
        if ifverbose(2):
            sys.stderr.write(
                "Codebook entries are saved to file %s\n" % out_code_file)
        write_data(out, out_code_file)
        return 0

    data = load_or_stream(in_data_file, buffer)
    codes = load_data(in_code_file, "codes")
    require_map(codes, in_code_file)
    require_same_dim(data, codes)

    progress = None
    if ifverbose(1) and sys.stderr.isatty():
        from ..utils.progress import Mprint

        progress = Mprint()
    try:
        out = som.som_train(
            codes, data, rlen, alpha, radius,
            alpha_type=alpha_type, random_order=random_order, rng=rng,
            use_weights=weights, use_fixed=fixed, mode="parity",
            snapshot=snapshot, progress=progress, buffer=buffer,
        )
    finally:
        if snapshot is not None:
            snapshot.close()

    if ifverbose(2):
        sys.stderr.write("Codebook entries are saved to file %s\n" % out_code_file)
    write_data(out, out_code_file)
    return 0


# ---------------------------------------------------------------------------
# qerror  (qerror.c)
# ---------------------------------------------------------------------------

def cmd_qerror(scanner: ArgScanner, progname: str, device) -> int:
    selfuncs(scanner)
    in_data_file = scanner.get("-din", ALWAYS)
    in_code_file = scanner.get("-cin", ALWAYS)
    buffer = scanner.get_int("-buffer", 0, OPTION)
    radius = scanner.get_float("-radius", 1.0, OPTION)
    qmode = scanner.get_int("-qetype", 0, OPTION)
    # -fast (extension): device evaluation with ONE host fetch —
    # float32 accumulation on the card (quality path), not the C bit order
    mode = "fast" if scanner.get("-fast", OPTION2) is not None else "parity"

    data = load_or_stream(in_data_file, buffer)
    codes = load_data(in_code_file, "codes")
    require_map(codes, in_code_file)
    require_same_dim(data, codes)

    if qmode > 0:
        qerror = som.find_qerror2(codes, data, radius, mode=mode, device=device)
    else:
        qerror = som.find_qerror(codes, data, mode=mode, device=device)
    if buffer > 0:
        # sample count recorded by the evaluation's own lap over the
        # stream (empties already skipped) — no second file pass
        nod = getattr(data, "entries_last_lap", None)
        if nod is None:
            nod = sum(c.n for c in data.chunks(laps=1))
    else:
        nod = data.n
    per_sample = np.float32(qerror) / np.float32(nod)
    if ifverbose(1):
        sys.stdout.write(
            "Quantization error of %s with map %s is %f per sample (%d samples)\n"
            % (in_data_file, in_code_file, per_sample, nod)
        )
    else:
        sys.stdout.write("%f\n" % per_sample)
    return 0


# ---------------------------------------------------------------------------
# vcal  (vcal.c)
# ---------------------------------------------------------------------------

def cmd_vcal(scanner: ArgScanner, progname: str, device) -> int:
    selfuncs(scanner)
    in_data_file = scanner.get("-din", ALWAYS)
    in_code_file = scanner.get("-cin", ALWAYS)
    out_code_file = scanner.get("-cout", ALWAYS)
    buffer = scanner.get_int("-buffer", 0, OPTION)
    numlabs = scanner.get_int("-numlabs", 1, OPTION)

    data = load_or_stream(in_data_file, buffer)
    codes = load_data(in_code_file, "codes")
    require_map(codes, in_code_file)
    require_same_dim(data, codes)

    out = tools.vcal(codes, data, numlabs=numlabs)
    save_codes(out, out_code_file)
    return 0


# ---------------------------------------------------------------------------
# visual  (visual.c)
# ---------------------------------------------------------------------------

def cmd_visual(scanner: ArgScanner, progname: str, device) -> int:
    selfuncs(scanner)
    in_data_file = scanner.get("-din", ALWAYS)
    in_code_file = scanner.get("-cin", ALWAYS)
    out_data_file = scanner.get("-dout", ALWAYS)
    buffer = scanner.get_int("-buffer", 0, OPTION)
    noskip = scanner.get("-noskip", OPTION2) is not None

    if buffer > 0:
        from ..data.io import write_data_chunks
        from ..data.streaming import StreamingReader

        data = StreamingReader(in_data_file, buffer,
                               skip_empty=not noskip)
        codes = load_data(in_code_file, "codes")
        require_map(codes, in_code_file)
        require_same_dim(data, codes)
        if ifverbose(2):
            sys.stderr.write(
                "Output entries are saved to file %s\n" % out_data_file)
        # per-sample output: stream chunk results straight to the file;
        # meta keeps the header for zero-entry inputs
        import numpy as _np

        from ..data.dataset import Dataset as _DS

        meta = _DS(points=_np.zeros((0, 3), _np.float32),
                   topol=codes.topol, neigh=codes.neigh,
                   xdim=codes.xdim, ydim=codes.ydim)
        write_data_chunks(
            (tools.visual(codes, c) for c in data.chunks(laps=1)),
            out_data_file, meta=meta)
        return 0
    data = load_data(in_data_file, "data", skip_empty=not noskip)
    codes = load_data(in_code_file, "codes")
    require_map(codes, in_code_file)
    require_same_dim(data, codes)

    out = tools.visual(codes, data)
    if ifverbose(2):
        sys.stderr.write("Output entries are saved to file %s\n" % out_data_file)
    write_data(out, out_data_file)
    return 0


# ---------------------------------------------------------------------------
# vfind  (vfind.c) — interactive multi-trial search
# ---------------------------------------------------------------------------

VFIND_DESCRIPTION = """This program will repeatedly run the initialization, training
and testing cycle for Self-Organizing Map algorithm.

In the following the training file name, the test file name
(that can be the same) and the map save file name are asked.
After them the type of map topology is asked, as well as
the type of neighborhood function. The x- and y-dimension
of the map should be integers and prefereably x-dimension
should be larger than y-dimension.

The training is done in two parts. First an ordering phase
that is usually shorter than the following converging phase.
The number of training cycles, the training rates and
the radius of the adaptation area are asked separately for
both phases. The fixed point qualifiers and weighting qualifiers
are used if the corresponding parameters were given.

The quantization error is computed for each map and
the best map (smallest quantization error) is saved to
the given file. If the verbose parameter allows the quantization
error is given for each separate trial.

After the answers have been given the training begins
and depending on the size of problem it may take a long time.

"""


def _prompt(msg: str) -> str:
    sys.stdout.write("%s: " % msg)
    sys.stdout.flush()
    line = sys.stdin.readline()
    if not line:
        return ""
    return line.split()[0] if line.split() else ""


def _prompt_int(msg: str, default: int = 0) -> int:
    from ..data.io import _atoi

    s = _prompt(msg)
    return _atoi(s) if s else default


def _prompt_float(msg: str, default: float = 0.0) -> float:
    from .params import _atof

    s = _prompt(msg)
    return _atof(s) if s else default


def cmd_vfind(scanner: ArgScanner, progname: str, device) -> int:
    selfuncs(scanner)
    sys.stdout.write(VFIND_DESCRIPTION)

    ntrials = _prompt_int("Give the number of trials")
    in_data_file = _prompt("Give the input data file name")
    in_test_file = _prompt("Give the input test file name")
    out_code_file = _prompt("Give the output map file name")

    topol = _topol(_prompt("Give the topology type"))
    if topol == Topology.UNKNOWN:
        if ifverbose(2):
            sys.stderr.write("Unknown topology type, using hexagonal\n")
        topol = Topology.HEXA
    neigh = _neigh(_prompt("Give the neighborhood type"))
    if neigh == Neighborhood.UNKNOWN:
        if ifverbose(2):
            sys.stderr.write("Unknown neighborhood type, using bubble\n")
        neigh = Neighborhood.BUBBLE

    xdim = _prompt_int("Give the x-dimension")
    ydim = _prompt_int("Give the y-dimension")
    length1 = _prompt_int("Give the training length of first part")
    alpha1 = _prompt_float("Give the training rate of first part")
    radius1 = _prompt_float("Give the radius in first part")
    length2 = _prompt_int("Give the training length of second part")
    alpha2 = _prompt_float("Give the training rate of second part")
    radius2 = _prompt_float("Give the radius in second part")
    sys.stdout.write("\n")

    fixed = bool(scanner.get_int("-fixed", 0, OPTION))
    weights = bool(scanner.get_int("-weights", 0, OPTION))
    scanner.get_int("-buffer", 0, OPTION)
    alpha_type = get_alpha_type(scanner)
    qmode = scanner.get_int("-qetype", 0, OPTION)
    # -fast (extension): run all N independent random-seed trials on the
    # device (minibatch training, models.som.vfind_trials)
    # instead of the reference's sequential per-sample loop.  Same seeds
    # and best-map selection; fast-path (not bit-parity) numerics.
    fast = scanner.get("-fast", OPTION2) is not None

    data = load_data(in_data_file, "data")
    testdata = load_data(in_test_file, "data")
    if xdim * ydim <= 0 or xdim < 0:
        err("Dimensions of map (%d %d) are incorrect" % (xdim, ydim))

    nod = testdata.n
    if fast and (weights or fixed or data.mask is not None):
        # the batched trial path carries no weight=/fixed=/mask handling;
        # fall back to the sequential parity trials rather than silently
        # training something other than what the flags requested
        if ifverbose(1):
            sys.stderr.write(
                "vfind: -fast ignored (-weights/-fixed/masked data use "
                "the sequential path)\n")
        fast = False
    if fast:
        best_codes, best_trial, best_q, qerrs = som.vfind_trials(
            data, testdata, ntrials, topol, neigh, xdim, ydim,
            [(length1, alpha1, radius1), (length2, alpha2, radius2)],
            alpha_type=alpha_type, qmode=qmode, device=device,
        )
        if ifverbose(1):
            for trial in range(ntrials, 0, -1):
                sys.stderr.write(
                    "%3d: %f\n" % (trial, np.float32(qerrs[trial]) / np.float32(nod)))
        if best_codes is not None:
            if ifverbose(2):
                sys.stdout.write(
                    "Codebook entries are saved to file %s\n" % out_code_file)
            write_data(best_codes, out_code_file)
            if ifverbose(1):
                sys.stdout.write(
                    "Smallest error with random seed %3d: %f\n"
                    % (best_trial, np.float32(best_q) / np.float32(nod))
                )
        return 0

    best_codes = None
    best_q = np.inf
    best_trial = 0
    trial = ntrials
    while trial:
        rng = CRandom()
        rng.init_random(trial)
        codes = som.randinit(data, topol, neigh, xdim, ydim, rng)
        codes = som.som_train(
            codes, data, length1, alpha1, radius1, alpha_type=alpha_type,
            rng=rng, use_weights=weights, use_fixed=fixed, mode="parity",
        )
        codes = som.som_train(
            codes, data, length2, alpha2, radius2, alpha_type=alpha_type,
            rng=rng, use_weights=weights, use_fixed=fixed, mode="parity",
        )
        if qmode > 0:
            q = som.find_qerror2(codes, testdata, radius=1.0, mode="parity")
        else:
            q = som.find_qerror(codes, testdata, mode="parity")
        if q < best_q:
            best_q = q
            best_trial = trial
            best_codes = codes
        if ifverbose(1):
            sys.stderr.write("%3d: %f\n" % (trial, np.float32(q) / np.float32(nod)))
        trial -= 1

    if best_codes is not None:
        if ifverbose(2):
            sys.stdout.write("Codebook entries are saved to file %s\n" % out_code_file)
        write_data(best_codes, out_code_file)
        if ifverbose(1):
            sys.stdout.write(
                "Smallest error with random seed %3d: %f\n"
                % (best_trial, np.float32(best_q) / np.float32(nod))
            )
    return 0
