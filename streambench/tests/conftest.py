"""The benchmark's tests: the repository's root and ``src`` on the path,
one CPU thread inside each test (the tiny model is dominated by thread
overhead), the process's count given back after it."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import pytest  # noqa: E402
import torch  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread for the test, the previous count restored after it,
    so that other tests collected in the same process keep theirs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cuda():
    """Skip unless a CUDA card is present (decided inside the test)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
