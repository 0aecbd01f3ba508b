"""File resolver with a search-path list
(reference: include/misaki/core/fresolver.h:12-57 — the reference keeps a
global resolver whose path list plugins consult via get_file_resolver();
same shape here, plus the scene's base_dir is always tried first)."""

from pathlib import Path


class FileResolver:
    def __init__(self):
        self.paths = []

    def append(self, path):
        self.paths.append(Path(path))

    def prepend(self, path):
        self.paths.insert(0, Path(path))

    def clear(self):
        self.paths = []

    def resolve(self, filename, base_dir=None):
        """First existing candidate among base_dir + search paths; falls
        back to base_dir/filename (callers raise their own load errors)."""
        f = Path(str(filename))
        if f.is_absolute():
            return f
        candidates = ([Path(base_dir)] if base_dir is not None else [])
        candidates += self.paths
        for d in candidates:
            c = d / f
            if c.exists():
                return c
        return (Path(base_dir) / f) if base_dir is not None else f

    def __repr__(self):
        return f"FileResolver({[str(p) for p in self.paths]})"


_resolver = FileResolver()


def get_file_resolver():
    return _resolver
