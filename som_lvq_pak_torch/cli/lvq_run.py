"""lvq_run: the interactive LVQ pipeline driver (lvq_run.c).

The reference composes child processes via system() with state flowing
through files (`.ini/.cod/.lvq/.cfo/.acc/.lra/.lrs/.lrt/.log`,
lvq_run.c:87-96).  Here the same stage semantics (init -> balance ->
coarse olvq1 -> fine-tune lvq1/2/3 -> accuracy test -> mcnemar compare,
with resumable/rollback-able training via the stashed learning-rate
sidecars) run in-process through the same CLI tool entry points, keeping
the identical on-disk state so classifiers are interchangeable with the
reference's.

The scriptable core is the Pipeline class; the menu loop replicates the
reference's interactive surface (lvq_run.c:1020-1234).

The port's copy of som_lvq_pak_tpu/cli/lvq_run.py (all of it): its stages
call the port's own `cli.main`, with the Pipeline's `device` (no stage
passes `-fast`, so none touches it)."""

from __future__ import annotations

import io
import os
import shutil
import sys
from dataclasses import dataclass, field
from typing import List, Optional

# state-file extensions (lvq_run.c:87-96)
INIT_EXT = ".ini"
TRAIN_EXT = ".cod"
RETRAIN_EXT = ".lvq"
CLASS_EXT = ".cfo"
ACC_EXT = ".acc"
ALPHA_EXT = ".lra"
INIT_ALPHA_EXT = ".lrs"
TRAIN_ALPHA_EXT = ".lrt"
LOG_EXT = ".log"

ALL_EXTS = (INIT_EXT, TRAIN_EXT, RETRAIN_EXT, CLASS_EXT, ACC_EXT,
            ALPHA_EXT, INIT_ALPHA_EXT, TRAIN_ALPHA_EXT, LOG_EXT)

# classifier status (lvq_run.c:58)
NOTHING, INIT, TRAIN, RETRAIN = 0, 1, 2, 3
# init options (lvq_run.c:57)
EVEN, PROP = 1, 2

DEFAULT_LVQ1_ALPHA = 0.03
DEFAULT_LVQ2_ALPHA = 0.03
DEFAULT_LVQ3_ALPHA = 0.03

SEP = "\n" + "=" * 78 + "\n"

MAX_NUM_CLASSIFIERS = 10

INTRO = """

This program acts as a very simple interactive interface to the lvq_pak.
To run this program, you must have a training data file in the format
explained in the document. Preferably, you ought to have independent test
data to evaluate the performance, too. In addition, you must have an idea
of how many codebook vectors you wish to use. This number depends on the
dimensionality of the training data, on the number of classes you
have and on the amount of training data available.
The program suggests default values for most of the parameters. We suggest
that you use them initially. To select the default value in question, just
press enter.
"""


@dataclass
class Classifier:
    """struct classifier (lvq_run.c:62-81)."""

    din: str = ""
    notv: int = 0
    cout: str = ""
    tdin: str = ""
    noc: int = 0
    init_opt: int = EVEN
    lvq_status: int = NOTHING
    rlen: int = 0
    totrlen: int = 0
    rt_lvq_type: int = 1
    rt_rlen: int = 0
    rt_alpha: float = 0.0
    rt_win: float = 0.3
    rt_epsilon: float = 0.1
    accuracy: float = 0.0
    history: List[str] = field(default_factory=list)
    train_hist_bgn: int = 0
    retrain_hist_bgn: int = 0

    # -- history / status management (lvq_run.c:134-165) --
    def decrease_status(self, newstatus: int) -> None:
        if newstatus >= self.lvq_status:
            return
        if newstatus == NOTHING:
            self.history = []
            self.train_hist_bgn = self.retrain_hist_bgn = 0
            _rm(self.cout + ALPHA_EXT)
        elif newstatus == INIT:
            self.history = self.history[: self.train_hist_bgn]
            self.retrain_hist_bgn = 0
        elif newstatus == TRAIN:
            self.history = self.history[: self.retrain_hist_bgn]
        else:
            sys.stdout.write("\nERROR: Cannot decrease status!\n")
            return
        self.lvq_status = newstatus


def _rm(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass


def _cp(src: str, dst: str) -> None:
    if os.path.exists(src):
        shutil.copy(src, dst)


def remove_classifier_files(cname: str) -> None:
    for ext in ALL_EXTS:
        _rm(cname + ext)


def copy_classifier_files(existing: str, new: str) -> None:
    for ext in (INIT_EXT, TRAIN_EXT, CLASS_EXT, ACC_EXT):
        _cp(existing + ext, new + ext)
    for ext in (RETRAIN_EXT, ALPHA_EXT, INIT_ALPHA_EXT, TRAIN_ALPHA_EXT):
        _cp(existing + ext, new + ext)


class Pipeline:
    """The scriptable stage runner: each stage shells into the in-process
    CLI tools (so on-disk state matches the reference's), echoing the
    command like systemd() (lvq_run.c:218-229)."""

    def __init__(self, out=None, device="cuda"):
        self.out = out or sys.stdout
        self.device = device

    def run_tool(self, c: Optional[Classifier], tool: str, *flags,
                 capture_to: Optional[str] = None) -> str:
        from . import main as cli_main

        args = [str(f) for f in flags]
        display = " ".join([tool] + args)
        self.out.write(">>%s\n" % display)
        self.out.flush()
        if capture_to is not None:
            old = sys.stdout
            sys.stdout = io.StringIO()
            try:
                cli_main([tool] + args, device=self.device)
                text = sys.stdout.getvalue()
            finally:
                sys.stdout = old
            with open(capture_to, "w") as f:
                f.write(text)
        else:
            cli_main([tool] + args, device=self.device)
            text = ""
        if c is not None:
            c.history.append(display)
        return text

    # -- stages (lvq_run.c:757-1014) --

    def init_classifier(self, c: Classifier, balance_rounds: int = 0,
                        ask_balance=None) -> None:
        if c.lvq_status >= INIT:
            return
        self.out.write("\nRunning initialization: %d\n" % c.init_opt)
        if c.init_opt not in (EVEN, PROP):
            # lvq_run.c:775-778
            self.out.write("\nIllegal initializing option %d\n" % c.init_opt)
            raise SystemExit(255)
        tool = "eveninit" if c.init_opt == EVEN else "propinit"
        self.run_tool(c, tool, "-noc", c.noc, "-din", c.din,
                      "-cout", c.cout + INIT_EXT, "-knn", 5)
        if not os.path.exists(c.cout + INIT_EXT):
            self.out.write("\nUnsuccesful initialization!\n")
            raise SystemExit(255)

        self.out.write(
            "\nNow you have the possibility to modify the number of codevectors"
            "\nso that the minimum distances between the codevectors within each"
            "\nclass will be balanced. The current situation is as follows:\n")
        self.run_tool(None, "mindist", "-cin", c.cout + INIT_EXT)

        # balance loop: interactive (ask_balance) or a fixed round count
        while True:
            if ask_balance is not None:
                if not ask_balance():
                    break
            else:
                if balance_rounds <= 0:
                    break
                balance_rounds -= 1
            self.run_tool(c, "balance", "-din", c.din,
                          "-cin", c.cout + INIT_EXT,
                          "-cout", c.cout + INIT_EXT, "-knn", 5)

        c.lvq_status = INIT
        c.train_hist_bgn = len(c.history)
        # stash balance's learning rates for retrain-keeping-init
        # (lvq_run.c:809-817)
        _cp(c.cout + ALPHA_EXT, c.cout + INIT_ALPHA_EXT)

    def train_classifier(self, c: Classifier) -> None:
        if c.lvq_status >= TRAIN:
            return
        if os.path.exists(c.cout + TRAIN_EXT):
            input_ext = TRAIN_EXT
        elif os.path.exists(c.cout + INIT_EXT):
            input_ext = INIT_EXT
        else:
            self.out.write(
                "\nERROR: No initialization has been done for the classifier!\n")
            raise SystemExit(255)

        self.out.write("\nStarting olvq1 training:\n")
        self.run_tool(c, "olvq1", "-din", c.din, "-cin", c.cout + input_ext,
                      "-cout", c.cout + TRAIN_EXT, "-rlen", c.rlen)
        c.totrlen += c.rlen
        c.rlen = c.totrlen
        c.lvq_status = TRAIN
        c.retrain_hist_bgn = len(c.history)
        if not os.path.exists(c.cout + TRAIN_EXT):
            self.out.write("\nUnsuccesful training!\n")
            raise SystemExit(255)
        # NOTE: in the reference the freshly written .lra survives here
        # only via lvq_run's earlier stash; lvqtrain removes it
        # (lvqtrain.c:249), so .lrt is copied from .lra if present
        _cp(c.cout + ALPHA_EXT, c.cout + TRAIN_ALPHA_EXT)

    def retrain_classifier(self, c: Classifier) -> None:
        if os.path.exists(c.cout + RETRAIN_EXT):
            ext = RETRAIN_EXT
        elif os.path.exists(c.cout + TRAIN_EXT):
            ext = TRAIN_EXT
        else:
            self.out.write("\nERROR: No training done for the classifier!\n")
            raise SystemExit(255)

        self.out.write("\nStarting training:\n")
        if c.rt_lvq_type == 1:
            self.run_tool(c, "lvq1", "-din", c.din, "-cin", c.cout + ext,
                          "-cout", c.cout + RETRAIN_EXT,
                          "-alpha", "%g" % c.rt_alpha, "-rlen", c.rt_rlen)
        elif c.rt_lvq_type == 2:
            self.run_tool(c, "lvq2", "-din", c.din, "-cin", c.cout + ext,
                          "-cout", c.cout + RETRAIN_EXT,
                          "-alpha", "%g" % c.rt_alpha, "-rlen", c.rt_rlen,
                          "-win", "%g" % c.rt_win)
        elif c.rt_lvq_type == 3:
            self.run_tool(c, "lvq3", "-din", c.din, "-cin", c.cout + ext,
                          "-cout", c.cout + RETRAIN_EXT,
                          "-alpha", "%g" % c.rt_alpha, "-rlen", c.rt_rlen,
                          "-win", "%g" % c.rt_win,
                          "-epsilon", "%g" % c.rt_epsilon)
        else:
            self.out.write("\nIllegal lvq-type %d\n" % c.rt_lvq_type)
            raise SystemExit(255)
        if not os.path.exists(c.cout + RETRAIN_EXT):
            self.out.write("\nUnsuccesful training!\n")
            raise SystemExit(255)
        c.lvq_status = RETRAIN

    def test_classifier(self, c: Classifier) -> None:
        if os.path.exists(c.cout + RETRAIN_EXT):
            ext = RETRAIN_EXT
        elif os.path.exists(c.cout + TRAIN_EXT):
            ext = TRAIN_EXT
        else:
            self.out.write("\nERROR: No training done for the classifier!\n")
            raise SystemExit(255)

        self.out.write(SEP)
        self.out.write("Starting testing:\n")
        acc_name = c.cout + ACC_EXT
        _rm(acc_name)
        self.run_tool(None, "accuracy", "-din", c.tdin,
                      "-cin", c.cout + ext, "-cfout", c.cout + CLASS_EXT,
                      capture_to=acc_name)
        with open(acc_name) as f:
            text = f.read()
        self.out.write(text)
        # parse "Total accuracy: N entries X %"
        for line in text.splitlines():
            if line.startswith("Total accuracy:"):
                c.accuracy = float(line.split()[4])

    def compare_classifiers(self, c1: Classifier, c2: Classifier) -> None:
        if c1.tdin != c2.tdin:
            self.out.write(
                "\nClassifiers have been tested with different files %s and %s!\n"
                % (c1.tdin, c2.tdin))
            return
        for c in (c1, c2):
            cif = c.cout + CLASS_EXT
            if not os.path.exists(cif):
                self.out.write(
                    "\nCannot read classification information file %s!\n" % cif)
                self.test_classifier(c)
        self.out.write(SEP)
        self.run_tool(None, "mcnemar", c1.cout + CLASS_EXT, c2.cout + CLASS_EXT)


# ---------------------------------------------------------------------------
# .log round trip (input_classifier/print_classifier, lvq_run.c:652-724)
# ---------------------------------------------------------------------------

def print_classifier(f, c: Classifier, interactive: bool = False) -> None:
    if interactive:
        f.write(SEP)
        f.write("\n")
    f.write("%s\t Training data file\n" % c.din)
    f.write("%d\t Number of training vectors\n" % c.notv)
    f.write("%s\t Testing data file\n" % c.tdin)
    f.write("%s\t Codebook vector files\n" % c.cout)
    f.write("%d\t Number of codebook vectors\n" % c.noc)
    f.write("%d\t Initializing option\n" % c.init_opt)
    f.write("%d\t Training cycles used\n" % c.totrlen)
    if not interactive:
        f.write("%d\t Training cycles used in latest teaching\n" % c.rlen)
        f.write("%d\t Current status\n" % c.lvq_status)
    if not interactive or c.lvq_status == RETRAIN:
        f.write("%d\t retrain LVQ-type\n" % c.rt_lvq_type)
        f.write("%d\t Training cycles used\n" % c.rt_rlen)
        f.write("%g\t Initial alpha\n" % c.rt_alpha)
        if not interactive or c.rt_lvq_type in (2, 3):
            f.write("%g\t Window width\n" % c.rt_win)
        if not interactive or c.rt_lvq_type == 3:
            f.write("%g\t Epsilon\n" % c.rt_epsilon)
    f.write("%g\t Accuracy\n" % c.accuracy)
    f.write("Recent history:\n")
    if not interactive:
        f.write("%d %d %d\n" % (len(c.history), c.train_hist_bgn,
                                c.retrain_hist_bgn))
    for h in c.history:
        f.write("%s\n" % h)


def input_classifier(f) -> Classifier:
    c = Classifier()

    def tok(conv):
        return conv(f.readline().split()[0])

    c.din = tok(str)
    c.notv = tok(int)
    c.tdin = tok(str)
    c.cout = tok(str)
    c.noc = tok(int)
    c.init_opt = tok(int)
    c.totrlen = tok(int)
    c.rlen = tok(int)
    c.lvq_status = tok(int)
    c.rt_lvq_type = tok(int)
    c.rt_rlen = tok(int)
    c.rt_alpha = tok(float)
    c.rt_win = tok(float)
    c.rt_epsilon = tok(float)
    c.accuracy = tok(float)
    f.readline()  # "Recent history:"
    nums = f.readline().split()
    hist_i, c.train_hist_bgn, c.retrain_hist_bgn = (
        int(nums[0]), int(nums[1]), int(nums[2]))
    c.history = [f.readline().rstrip("\n") for _ in range(hist_i)]
    return c


def save_log(c: Classifier) -> None:
    with open(c.cout + LOG_EXT, "w") as f:
        print_classifier(f, c)


def load_log(name: str) -> Classifier:
    with open(name + LOG_EXT) as f:
        return input_classifier(f)


# ---------------------------------------------------------------------------
# Interactive front end (lvq_run.c:1020-1234)
# ---------------------------------------------------------------------------

def _getsb() -> str:
    line = sys.stdin.readline()
    return line.rstrip("\n")


def _estimate_needed_codevectors(din: str):
    """noc ~= 0.4*nc*(nc-1+dim/2) capped at N (lvq_run.c:362-399)."""
    from ..data.io import read_data
    from ..data.labels import GLOBAL_LABELS
    from ..utils.hitlist import Hitlist

    data = read_data(din)
    classes = Hitlist.from_labels(data.first_labels())
    sys.stdout.write(
        "\n\n The dimensionality of the training data in file %s is %d."
        % (din, data.dim))
    total = 0
    nol = 0
    for lab, freq in classes.items():
        sys.stdout.write("In class %s are %d units\n"
                         % (GLOBAL_LABELS.to_label(lab), freq))
        total += freq
        nol += 1
    sys.stdout.write(" The total number of training vectors is %d.\n\n" % total)
    noc = int(0.4 * nol * (nol - 1 + data.dim // 2))
    if noc > total:
        noc = total
    return noc, total


def _read_classifier_parameters(c: Classifier) -> None:
    sys.stdout.write(SEP)
    sys.stdout.write("Enter now the parameters and associated filenames for"
                     " this LVQ-classifier.")
    while True:
        if c.din:
            sys.stdout.write("\n*Enter training data file (%s): " % c.din)
        else:
            sys.stdout.write("\n*Enter training data file: ")
        l = _getsb()
        if l:
            c.decrease_status(NOTHING)
            c.noc = 0
            c.din = l.split()[0]
        if c.din and os.path.exists(c.din):
            break
        sys.stdout.write("\n Cannot read file %s\n" % c.din)

    if c.noc == 0:
        sys.stdout.write("\n Reading input data...")
        sys.stdout.flush()
        c.noc, c.notv = _estimate_needed_codevectors(c.din)

    sys.stdout.write("*Enter the desired total number of codevectors which will be\n")
    sys.stdout.write("*divided among classes (default: %d): " % c.noc)
    l = _getsb()
    if l:
        c.noc = int(l.split()[0])
        c.decrease_status(NOTHING)
        c.rlen = 0

    sys.stdout.write("\nNext, you have to choose how to initialize the codevectors.\n")
    sys.stdout.write("The options are: \n")
    sys.stdout.write("\t1: Equal allocation of codevectors to each class.\n")
    sys.stdout.write("\t2: Proportional to the amount of training data for each class.\n")
    sys.stdout.write("We recommend that you use option 1.\n")
    sys.stdout.write("*Enter your choice (default is %d): " % c.init_opt)
    l = _getsb()
    if l:
        i = int(l.split()[0])
        if i != c.init_opt:
            c.init_opt = i
            c.decrease_status(NOTHING)

    sys.stdout.write("\nYou must now specify how many training iterations are"
                     " used. We suggest ")
    sys.stdout.write("\na number that is about 40 times the number of codebook"
                     " vectors.")
    if c.rlen == 0:
        c.rlen = 40 * c.noc
        c.decrease_status(INIT)
    sys.stdout.write("\n*Enter the number of training iterations (%d): " % c.rlen)
    l = _getsb()
    if l:
        nrlen = int(l.split()[0])
        if c.lvq_status >= TRAIN:
            if nrlen > c.totrlen:
                # continue previous olvq1 training from the stashed state
                # (lvq_run.c:510-531)
                sys.stdout.write(
                    "You entered a number larger than used previously. In this"
                    " case we can\ncontinue previous training because olvq1"
                    " saves its final state to a file.")
                c.rlen = nrlen - c.totrlen
                _cp(c.cout + TRAIN_ALPHA_EXT, c.cout + ALPHA_EXT)
                c.decrease_status(TRAIN)
                c.lvq_status = INIT
            else:
                # roll back to post-init state (lvq_run.c:532-554)
                c.decrease_status(INIT)
                c.rlen = nrlen
                c.totrlen = 0
                _rm(c.cout + ALPHA_EXT)
                _rm(c.cout + TRAIN_ALPHA_EXT)
                _rm(c.cout + TRAIN_EXT)
                _cp(c.cout + INIT_ALPHA_EXT, c.cout + ALPHA_EXT)
        else:
            c.rlen = nrlen
            c.totrlen = 0
            c.decrease_status(INIT)

    while True:
        sys.stdout.write("\n*Enter the test data file")
        sys.stdout.write(" (%s): " % c.tdin if c.tdin else ": ")
        l = _getsb()
        if l:
            c.tdin = l.split()[0]
            c.accuracy = 0.0
        if c.tdin and os.path.exists(c.tdin):
            break
        sys.stdout.write("\n Cannot read file %s\n" % c.tdin)


def _read_classifier_file(c: Classifier) -> None:
    while True:
        sys.stdout.write(
            "\n*Enter the name of the file to which the codebook vectors"
            "\n*will be stored (without .cod extension): ")
        l = _getsb()
        if not l:
            continue
        c.cout = l
        if os.path.exists(l + TRAIN_EXT):
            sys.stdout.write("\n File %s already exists" % (l + TRAIN_EXT))
            sys.stdout.write("\n Enter y to overwrite: ")
            if _getsb().startswith("y"):
                remove_classifier_files(c.cout)
                return
        else:
            return


def _read_retrain_parameters(c: Classifier, add: bool) -> None:
    sys.stdout.write("\nChoose the type of LVQ to be used for fine-tuning.\n")
    sys.stdout.write("\t1: LVQ1\n\t2: LVQ2.1\n\t3: LVQ3\n")
    sys.stdout.write("*Enter your choice (%d): " % c.rt_lvq_type)
    l = _getsb()
    if l:
        i = int(l.split()[0])
        if i not in (1, 2, 3):
            i = 1
        if i != c.rt_lvq_type:
            c.rt_alpha = 0.0
            c.rt_lvq_type = i
            if not add:
                c.decrease_status(TRAIN)

    if c.rt_alpha == 0.0:
        c.rt_alpha = {1: DEFAULT_LVQ1_ALPHA, 2: DEFAULT_LVQ2_ALPHA,
                      3: DEFAULT_LVQ3_ALPHA}.get(c.rt_lvq_type, 0.02)

    sys.stdout.write("\n*Enter the initial value for alpha (%g): " % c.rt_alpha)
    l = _getsb()
    if l:
        c.rt_alpha = float(l.split()[0])
        if not add:
            c.decrease_status(TRAIN)

    sys.stdout.write("\nYou must now specify how many training iterations are used.")
    sys.stdout.write("\nWe suggest a number that is at least five times the number of ")
    sys.stdout.write("\ntraining vectors in your file %s." % c.din)
    if c.rt_rlen == 0:
        c.rt_rlen = 5 * c.notv
        if not add:
            c.decrease_status(TRAIN)
    sys.stdout.write("\n*Enter the number of training iterations (%d): " % c.rt_rlen)
    l = _getsb()
    if l:
        c.rt_rlen = int(l.split()[0])
        if not add:
            c.decrease_status(TRAIN)

    if c.rt_lvq_type in (2, 3):
        sys.stdout.write("\nSpecify the width of the window in which the"
                         " adaptation takes place.")
        sys.stdout.write("\n*Enter the width (%g): " % c.rt_win)
        l = _getsb()
        if l:
            c.rt_win = float(l.split()[0])
            if not add:
                c.decrease_status(TRAIN)
    if c.rt_lvq_type == 3:
        sys.stdout.write("\n*Enter the stabilizing factor (epsilon) (%g): "
                         % c.rt_epsilon)
        l = _getsb()
        if l:
            c.rt_epsilon = float(l.split()[0])
            if not add:
                c.decrease_status(TRAIN)


MENU = """
 0 -> Quit and save current classifiers.
 1 -> Create a completely new classifier from scratch.
 2 -> Create a new classifier by copying the parameters of an old one.
      Use option 3 thereafter to modify the new classifier.
 3 -> Modify the parameters of a classifier and train it. You can modify as
      many or as few parameters as you wish. However, if you have done repeated
      fine-tuning, only the parameters of the latest one are in memory and
      modifiable. All previous repeated cycles of fine-tuning are then replaced
      by this new cycle with modified parameters.
 4 -> Fine-tune a classifier by using LVQ1, LVQ2.1, or LVQ3.
      You can repeat this step as many times as you wish.
 5 -> Delete a classifier.
 6 -> View the parameters of a classifier.
 7 -> Compare whether two classifiers tested with the same data have any
      statistically significant difference.
 Enter your choice --> """


def _ask_balance() -> bool:
    sys.stdout.write("\nDo you want to run an iteration of balancing? y/n"
                     " (default=n) ")
    return _getsb().startswith("y")


def _pick_index(prompt: str, nocl: int) -> int:
    if nocl == 1:
        return 1
    while True:
        sys.stdout.write("\n%s [1..%d]: " % (prompt, nocl))
        l = _getsb()
        try:
            i = int(l.split()[0])
        except (ValueError, IndexError):
            return 1
        if 1 <= i <= nocl:
            return i
        sys.stdout.write("\nNo such classifier %d!" % i)


def main(argv: Optional[List[str]] = None, device="cuda") -> int:
    if argv is None:
        argv = sys.argv[1:]
    pipe = Pipeline(device=device)
    classifiers: List[Classifier] = []

    sys.stdout.write(INTRO)
    sys.stdout.write("\nPress enter to continue.")
    _getsb()

    # flags consume their value too (retrieve_classifiers' `else i++`,
    # lvq_run.c:738-748)
    names = []
    i = 0
    while i < len(argv):
        if argv[i].startswith("-"):
            i += 2
        else:
            names.append(argv[i])
            i += 1
    for a in names:
        if not os.path.exists(a + LOG_EXT):
            sys.stdout.write("\nERROR: cannot find classifier %s!\n" % (a + LOG_EXT))
            continue
        sys.stdout.write("\nReading classifier %s." % (a + LOG_EXT))
        classifiers.append(load_log(a))

    while True:
        nocl = len(classifiers)
        sys.stdout.write(SEP)
        if nocl == 0:
            sys.stdout.write("You don't have any classifiers yet. Start by option 1.")
        elif nocl == 1:
            sys.stdout.write("You have now 1 classifier. Do you want to:")
        else:
            sys.stdout.write("You have now %d classifiers. Do you want to:" % nocl)
        sys.stdout.write(MENU)
        l = _getsb()
        try:
            opt = int(l.split()[0])
        except (ValueError, IndexError):
            opt = 0

        if opt == 1:
            c = Classifier()
            _read_classifier_parameters(c)
            _read_classifier_file(c)
            pipe.init_classifier(c, ask_balance=_ask_balance)
            pipe.train_classifier(c)
            pipe.test_classifier(c)
            classifiers.append(c)
        elif opt == 2:
            if nocl < 1:
                sys.stdout.write("\nNo classifiers to be copied.")
                continue
            i = _pick_index("Enter the classifier to be copied", nocl)
            import copy

            c = copy.deepcopy(classifiers[i - 1])
            _read_classifier_file(c)
            c.history = [
                h.replace(" %s." % classifiers[i - 1].cout, " %s." % c.cout)
                for h in classifiers[i - 1].history
            ]
            copy_classifier_files(classifiers[i - 1].cout, c.cout)
            classifiers.append(c)
        elif opt == 3:
            if nocl < 1:
                sys.stdout.write("\nNo classifiers to be replaced.")
                continue
            i = _pick_index("Enter the classifier to be replaced", nocl)
            c = classifiers[i - 1]
            status = c.lvq_status
            _read_classifier_parameters(c)
            pipe.init_classifier(c, ask_balance=_ask_balance)
            pipe.train_classifier(c)
            if status == RETRAIN:
                _rm(c.cout + RETRAIN_EXT)
                c.decrease_status(TRAIN)
                sys.stdout.write("\nThe previous classifier was fine-tuned.")
                sys.stdout.write("\nFine-tune this one, too? [y/n] (default=n) ")
                if _getsb().startswith("y"):
                    _read_retrain_parameters(c, False)
                    pipe.retrain_classifier(c)
            pipe.test_classifier(c)
        elif opt == 4:
            if nocl < 1:
                sys.stdout.write("\nNo classifiers to be retrained.")
                continue
            i = _pick_index("Enter the classifier", nocl)
            c = classifiers[i - 1]
            _read_retrain_parameters(c, True)
            pipe.retrain_classifier(c)
            pipe.test_classifier(c)
        elif opt == 5:
            if nocl < 1:
                sys.stdout.write("\nNo classifiers to be deleted.")
                continue
            i = _pick_index("Enter the classifier to be deleted", nocl)
            remove_classifier_files(classifiers[i - 1].cout)
            del classifiers[i - 1]
        elif opt == 6:
            if nocl < 1:
                sys.stdout.write("\nNo classifiers to be viewed.")
                continue
            i = _pick_index("Enter the classifier", nocl)
            print_classifier(sys.stdout, classifiers[i - 1], interactive=True)
        elif opt == 7:
            if nocl < 1:
                sys.stdout.write("\nCannot compare less than two classifiers!\n")
                continue
            if nocl == 2:
                i, j = 1, 2
            else:
                i = _pick_index("Enter the 1st classifier", nocl)
                j = _pick_index("Enter the 2nd classifier", nocl)
            pipe.compare_classifiers(classifiers[i - 1], classifiers[j - 1])
        else:
            # 0 or invalid: quit & save (lvq_run.c:1208-1228)
            if classifiers:
                sys.stdout.write("\nAs the result of this session of lvq_run,")
                sys.stdout.write("\nthe following classifiers remain on disk:")
                for c in classifiers:
                    sys.stdout.write("\n   %s" % c.cout)
                    save_log(c)
                sys.stdout.write(
                    "\n\nYou can read in the stored classifiers by starting"
                    " lvq_run as follows:"
                    "\n>> lvq_run classifier1 classifier2 ... classifier10"
                    "\nDo not enter any extensions to classifier filenames,"
                    " just the baseforms.")
            sys.stdout.write("\n\n")
            return 0
