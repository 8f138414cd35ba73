"""Stand-ins for the port's built kernel libraries, so the CPU tests can
drive each wrapper's launch path (arguments, routes, counts, bindings)
without nvcc or a card: ``stub_libraries(monkeypatch)`` makes
``repro_torch.kernels.build.load`` open a ``StubLibrary`` instead of a
built shared library, and every launch call its stream with 0. A helper
of ``test_torch_kernels.py`` and ``test_torch_lm_kernels.py``; it holds
no tests itself.
"""
import collections
from pathlib import Path


class StubLibrary:
    """Stands in for a loaded ``ctypes.CDLL``: records each entry point's
    calls (names in ``calls``, arguments in ``args``), checks each call's
    argument count against the argtypes bound when the library loaded, and
    counts those bindings in ``bound``."""

    def __init__(self, path):
        self.name = Path(path).name[len("lib"):].rsplit("-", 1)[0]
        self.calls, self.args, self.bound = [], [], collections.Counter()

    def __getattr__(self, entry):
        if entry.startswith("__"):
            raise AttributeError(entry)
        lib = self

        class Entry:
            def __setattr__(self, key, value):
                if key == "argtypes":
                    lib.bound[entry] += 1
                object.__setattr__(self, key, value)

            def __call__(self, *args):
                assert len(args) == len(self.argtypes), (entry, len(args))
                lib.calls.append(entry)
                lib.args.append(args)
                return 0
        fn = Entry()
        self.__dict__[entry] = fn
        return fn


def stub_libraries(monkeypatch):
    """Route ``build.load`` to stand-ins (no build, nothing cached from
    before); returns {library name: StubLibrary}, filled as each loads."""
    from repro_torch.kernels import build
    libs = {}

    def open_library(path):
        lib = StubLibrary(path)
        libs[lib.name] = lib
        return lib
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "build_all", lambda names=None: {})
    monkeypatch.setattr(build.ctypes, "CDLL", open_library)
    monkeypatch.setattr(build, "on_device", lambda device, call: call(0))
    return libs
