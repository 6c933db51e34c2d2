"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration: ``configs/<name>.json`` (its ``file`` entry), whose
  ``reference`` entry names its plain reference model's module;
* the reference's optimizer update: ``reference/optim/<name>.py``, by the
  program config's ``training.optimizer``;
* a traffic mix: ``traffic/<name>.json``, whose ``driver`` names a module
  ``drivers/<driver>.py``;
* a per-layer metric: ``metrics/<name>.py`` with ``read(run)``;
* a kernel's work: every ``kernels/*.py``;
* a cell's correctness limits: ``limits/<cell>.json``;
* a cell's tiny CPU rehearsal: ``rehearsal/<cell>.json``.

Adding any of them is adding a file and an entry; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HBENCH = Path(__file__).resolve().parents[1]
ROOT = HBENCH.parent


def load_module(path: Path, name: Optional[str] = None) -> ModuleType:
    """Import a file by path (metric and kernel file names hold dots)."""
    spec = importlib.util.spec_from_file_location(name or f"hbench_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """One ``BENCHMARK.json`` (or its ``spec`` dict) and the harness
    directory ``home`` its traffic, limits, metrics, drivers and kernel
    counts are found in."""

    def __init__(self, path: Path = ROOT / "BENCHMARK.json", spec: Optional[Dict] = None,
                 home: Path = HBENCH):
        self.root = Path(path).resolve().parent
        self.spec = spec if spec is not None else json.loads(Path(path).read_text())
        self.home = Path(home)

    def workload(self, name: str) -> Dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in self.spec['workloads']]}")

    def config(self, name: str) -> Dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return dict(json.loads((self.root / c["file"]).read_text()), name=name)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def reference(self, config: Dict) -> ModuleType:
        """The plain reference model's module that ``config`` (``config()``)
        names: ``build(model_cfg, tree)``, ``RESIDUAL_LAST``
        (``hbench/README.md``)."""
        return load_module(self.root / config["reference"], f"hbench_reference_{config['name']}")

    def optimizer(self, name: str) -> ModuleType:
        """The reference's update of optimizer ``name``: ``update(params,
        grads, state, training, step)``."""
        return load_module(self.home / "reference" / "optim" / f"{name}.py", f"hbench_optim_{name}")

    def traffic(self, name: str) -> Dict:
        return json.loads((self.home / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> Dict:
        return json.loads((self.home / "limits" / f"{cell}.json").read_text())

    def rehearsal(self, cell: str) -> Dict:
        """The cell's tiny overrides for the CPU rehearsal."""
        return json.loads((self.home / "rehearsal" / f"{cell}.json").read_text())

    def end_to_end(self, cell: str) -> List[Dict]:
        return [m for m in self.spec["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[Dict]:
        """The per-layer metrics a cell reports: those that list it, and
        those without a list that move an end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in e2e else [])]

    def metric_reader(self, name: str) -> ModuleType:
        return load_module(self.home / "metrics" / f"{name}.py")

    def driver(self, name: str) -> ModuleType:
        return load_module(self.home / "drivers" / f"{name}.py", f"hbench_driver_{name}")

    def kernels(self) -> Dict[str, ModuleType]:
        """Every kernel count under ``kernels/``, by file name."""
        return {p.stem: load_module(p, f"hbench_kernel_{p.stem}")
                for p in sorted((self.home / "kernels").glob("*.py"))}
