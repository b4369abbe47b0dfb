"""The reference's contract linter (``repro.analysis``) over the port.

``Project(ROOT, rel_dirs=("src/repro_torch",))`` reads every ``.py``
file of the port, and each of the five registered passes reports no
active finding there: ``bit-contract`` (raw transcendentals and ``@`` on
the tracker's bit-identity path), ``kernel-contract``,
``lock-discipline`` (``# guarded-by:`` fields read and written under
their lock), ``obs-naming`` (span, metric, route, health and alert names
against the reference's ``src/repro/obs/README.md``, both directions)
and ``tracked-bytecode``.  Every suppression in the port carries its
reason.  So that a clean report cannot come from a pass that read
nothing, one fault of each of three kinds is planted in a copy of the
port under ``tmp_path`` (an unlocked read, a raw ``np.tanh`` on the
host tracker's GRU, a metric renamed away from its README row) and each
must be found, at its file and line, and nothing else.
"""
import shutil
from pathlib import Path

import pytest

from repro.analysis import PASSES, Project, run_passes

ROOT = Path(__file__).resolve().parents[1]
PORT = "src/repro_torch"
README = "src/repro/obs/README.md"


def active(report, pass_id=None):
    return [f for f in report.findings if not f.suppressed
            and (pass_id is None or f.pass_id == pass_id)]


@pytest.fixture(scope="module")
def port_report():
    proj = Project(ROOT, rel_dirs=(PORT,))
    return proj, run_passes(proj)


def test_project_holds_every_port_file(port_report):
    proj, _ = port_report
    want = sorted(p.relative_to(ROOT).as_posix()
                  for p in (ROOT / PORT).rglob("*.py")
                  if "__pycache__" not in p.parts)
    assert [sf.rel for sf in proj.files] == want
    assert len(want) > 90
    assert all(sf.parse_error is None for sf in proj.files)


def test_all_five_passes_ran():
    assert set(PASSES) == {"bit-contract", "kernel-contract",
                           "lock-discipline", "obs-naming",
                           "tracked-bytecode"}


@pytest.mark.parametrize("pass_id", sorted(PASSES))
def test_port_has_no_active_finding(port_report, pass_id):
    _, rep = port_report
    found = active(rep, pass_id)
    assert found == [], [str(f) for f in found]


def test_port_has_no_unjustified_suppression(port_report):
    proj, rep = port_report
    assert active(rep) == [], [str(f) for f in active(rep)]
    sups = [(sf.rel, s.line, s.why) for sf in proj.files
            for s in sf.suppressions]
    assert len(sups) >= 20
    assert all(why for _, _, why in sups), sups
    assert all(f.justification for f in rep.findings if f.suppressed)


# ---------------------------------------------------------------------------
# planted faults: the passes really read the port
# ---------------------------------------------------------------------------

def _plant(path: Path, old: str, new: str) -> int:
    """Replace the one occurrence of ``old`` in ``path``; -> the 1-based
    line where it started."""
    text = path.read_text()
    assert text.count(old) == 1, old
    path.write_text(text.replace(old, new))
    return text[:text.index(old)].count("\n") + 1


def _copy(tmp_path: Path) -> Path:
    shutil.copytree(ROOT / PORT, tmp_path / PORT,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / README).parent.mkdir(parents=True)
    shutil.copy(ROOT / README, tmp_path / README)
    return tmp_path


def test_copy_of_port_is_clean(tmp_path):
    rep = run_passes(Project(_copy(tmp_path), rel_dirs=(PORT,)))
    assert active(rep) == [], [str(f) for f in active(rep)]


def _lock_fault(root):
    """_Broker._should_flush loses its ``# holds-lock: _cv``."""
    rel = f"{PORT}/core/executor.py"
    line = _plant(root / rel, "    # holds-lock: _cv\n"
                              "    def _should_flush(self) -> bool:\n",
                  "    def _should_flush(self) -> bool:\n")
    # the three guarded reads of its body, one line each after the def
    return {(rel, line + 1), (rel, line + 3)}


def _bit_fault(root):
    """The host GRU's candidate through raw np.tanh."""
    rel = f"{PORT}/core/tracker.py"
    line = _plant(root / rel,
                  'cand = fm.np_tanh(fm.np_matmul(hf2, p["gru/wh"])',
                  'cand = np.tanh(fm.np_matmul(hf2, p["gru/wh"])')
    return {(rel, line)}


def _naming_fault(root):
    """A broker mirror renamed away from its README row."""
    rel = f"{PORT}/core/executor.py"
    line = _plant(root / rel, 'f"broker.{self._metric}.units_in"',
                  'f"broker.{self._metric}.units"')
    readme = (ROOT / README).read_text().splitlines()
    row = next(i for i, ln in enumerate(readme, start=1)
               if "`.units_in`" in ln)
    return {(rel, line), (README, row)}


@pytest.mark.parametrize("pass_id,plant", [
    ("lock-discipline", _lock_fault),
    ("bit-contract", _bit_fault),
    ("obs-naming", _naming_fault),
])
def test_planted_fault_is_found(tmp_path, pass_id, plant):
    root = _copy(tmp_path)
    want = plant(root)
    rep = run_passes(Project(root, rel_dirs=(PORT,)))
    found = active(rep)
    assert {f.pass_id for f in found} == {pass_id}, \
        [str(f) for f in found]
    assert {(f.path, f.line) for f in found} == want, \
        [str(f) for f in found]
