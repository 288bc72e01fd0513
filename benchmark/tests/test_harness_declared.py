"""A configuration's reference is new files: a model, an env and a graph
builder written into a copy of the frozen package are found by the
factories, and their NamedTuples by `to_reference`, with no file that was
there edited; a name declared twice is refused, naming both files."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import manifest

FROZEN = Path("benchmark/reference/frozen")

THROWAWAY = {
    "models/throwaway.py": (
        "import torch\n\n\nclass Throwaway(torch.nn.Module):\n"
        "    def __init__(self, width=3, **kwargs):\n        super().__init__()\n        self.width = width\n\n\n"
        "MODELS = {'throwaway': Throwaway}\n"),
    "envs/throwaway.py": (
        "from typing import NamedTuple\n\nimport torch\n\n\nclass ThrowawayState(NamedTuple):\n    pos: torch.Tensor\n\n\n"
        "class ThrowawayEnv:\n    def __init__(self, num_envs, device):\n        self.num_envs, self.device = num_envs, device\n\n\n"
        "TASKS = {'throwaway_task': lambda num_envs, device, **kwargs: ThrowawayEnv(num_envs, device)}\n"),
    "graphs/throwaway.py": (
        "from ..envs.throwaway import ThrowawayEnv\n\n\nclass ThrowawayBuilder:\n"
        "    def __init__(self, env, dist_as_pos, **kwargs):\n        self.env, self.dist_as_pos = env, dist_as_pos\n\n\n"
        "BUILDERS = {ThrowawayEnv: ThrowawayBuilder}\n"),
}

FOUND = """
from typing import NamedTuple
import torch
from benchmark import reference
from benchmark.reference.frozen.envs import make_env
from benchmark.reference.frozen.models import get_model
from benchmark.reference.frozen.train.builders import make_graph_builder

model = get_model("throwaway", width=5)
assert type(model).__module__ == "benchmark.reference.frozen.models.throwaway" and model.width == 5
env = make_env("throwaway_task", num_envs=3, device="cpu")
assert type(env).__name__ == "ThrowawayEnv" and env.num_envs == 3
builder = make_graph_builder(env, dist_as_pos=True)
assert type(builder).__name__ == "ThrowawayBuilder" and builder.env is env and builder.dist_as_pos


class ThrowawayState(NamedTuple):  # the port's type of the same name
    pos: torch.Tensor


x = reference.to_reference(ThrowawayState(torch.ones(2)))
assert type(x).__module__ == "benchmark.reference.frozen.envs.throwaway" and torch.equal(x.pos, torch.ones(2))
# the built-in entries are as they were
assert type(make_env("rigid_insertion", num_envs=8, device="cpu")).__name__ == "RigidEnv"
assert type(make_graph_builder(make_env("rigid_insertion", num_envs=8, device="cpu"), True)).__name__ == "RigidGraphBuilder"
assert reference.REFERENCE_TYPES["RigidEnvState"].__module__ == "benchmark.reference.frozen.envs.rigid"
try:
    get_model("nothing")
except ValueError as e:
    assert "throwaway" in str(e) and "hepi" in str(e)
else:
    raise AssertionError("an unknown model was built")
print("found")
"""


def _copy(tmp_path: Path, files) -> Path:
    shutil.copytree(manifest.HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    for name, text in files.items():
        (tmp_path / FROZEN / name).write_text(text)
    return tmp_path


def _python(cwd: Path, code: str):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True, timeout=300)


def _files(root: Path):
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_model_env_and_builder_are_found_by_their_files_alone(tmp_path):
    root = _copy(tmp_path, THROWAWAY)
    out = _python(root, FOUND)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "found"
    before, after = _files(manifest.HERE), _files(root / "benchmark")
    assert {p: b for p, b in after.items() if p in before} == before  # no file that was there is edited
    assert set(after) - set(before) == {Path("reference/frozen") / name for name in THROWAWAY}


DUPLICATES = {
    "model": ({"models/twice.py": "MODELS = {'hepi': object}\n"}, "from benchmark.reference.frozen.models import get_model; get_model('hepi')",
              ["models/__init__.py", "models/twice.py"]),
    "task": ({"envs/a_task.py": "TASKS = {'x': None}\n", "envs/b_task.py": "TASKS = {'x': None}\n"},
             "from benchmark.reference.frozen.envs import make_env; make_env('x', device='cpu')",
             ["envs/a_task.py", "envs/b_task.py"]),
    "builder": ({"graphs/twice.py": "from ..envs.rigid import RigidEnv\n\nBUILDERS = {RigidEnv: None}\n"},
                "from benchmark.reference.frozen.envs import make_env; "
                "from benchmark.reference.frozen.train.builders import make_graph_builder; "
                "make_graph_builder(make_env('rigid_insertion', num_envs=8, device='cpu'), True)",
                ["train/builders.py", "graphs/twice.py"]),
    "named_tuple": ({"envs/twice.py": "from typing import NamedTuple\n\n\nclass RigidEnvState(NamedTuple):\n    x: int\n"},
                    "import benchmark.reference", ["envs/rigid.py", "envs/twice.py"]),
}


@pytest.mark.parametrize("kind", sorted(DUPLICATES))
def test_a_name_declared_twice_is_refused_naming_both_files(tmp_path, kind):
    files, code, named = DUPLICATES[kind]
    out = _python(_copy(tmp_path, files), code)
    assert out.returncode != 0
    message = out.stderr.strip().splitlines()[-1]
    assert "ValueError" in message and "declared twice" in message, out.stderr
    assert all(name in message for name in named), message
