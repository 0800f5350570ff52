"""Incremental artifact publishing for long-running CLIs.

The port's own copy of ``distil_whisper_tpu.utils.publish``.  The reference
pseudo-labelling script pushes its work product off the worker as it goes:
every ``logging_steps`` it dumps a CSV and ``upload_folder``s it to the Hub,
and at the end it pushes the labelled dataset (reference
``training/run_pseudo_labelling.py:887-925, 1015-1018``), so a multi-day
labelling job survives preemption with at most ``logging_steps`` batches of
rework and downstream consumers can start while it runs.

A pluggable hook, so the CLI runs the same whether publishing is off,
local, or remote:

* :class:`LocalMirrorPublisher`: copy artifacts into a mirror directory
  (an NFS or object-store mount).  Works without network and is therefore
  the tested backend.
* :class:`HubPublisher`: ``huggingface_hub`` ``upload_file`` /
  ``upload_folder`` with the reference's repo layout (dataset repo,
  ``exist_ok`` create).  ``huggingface_hub`` is imported only when no client
  is given; the call sequence is tested against an injected fake client.

Publish failures never kill the run: they are logged and the run keeps
labelling; the artifacts remain on local disk regardless.
"""

from __future__ import annotations

import logging
import shutil
from pathlib import Path
from typing import Iterable, Optional, Sequence

logger = logging.getLogger("distil_whisper_tpu_torch")


class Publisher:
    """Interface: ``publish`` small incremental artifacts (CSV flushes),
    ``finalize`` the whole output directory once at the end."""

    def publish(self, out_dir: Path, files: Sequence[Path],
                message: str) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def finalize(self, out_dir: Path, message: str) -> None:  # pragma: no cover
        raise NotImplementedError


class LocalMirrorPublisher(Publisher):
    """Mirror artifacts under ``mirror_dir``, preserving paths relative to
    the run's output dir.  Copies go through a temp name + atomic rename so
    a reader of the mirror never sees a half-written CSV."""

    def __init__(self, mirror_dir: str):
        self.root = Path(mirror_dir)
        self.root.mkdir(parents=True, exist_ok=True)

    def _copy_one(self, out_dir: Path, f: Path) -> None:
        rel = f.relative_to(out_dir)
        dst = self.root / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        tmp = dst.with_name(dst.name + ".tmp")
        shutil.copyfile(f, tmp)
        tmp.replace(dst)

    def publish(self, out_dir: Path, files: Sequence[Path],
                message: str) -> None:
        for f in files:
            if Path(f).is_file():
                self._copy_one(Path(out_dir), Path(f))

    def finalize(self, out_dir: Path, message: str) -> None:
        out_dir = Path(out_dir)
        for f in sorted(out_dir.rglob("*")):
            if f.is_file():
                self._copy_one(out_dir, f)


class HubPublisher(Publisher):
    """Hub-backed publisher with the reference's repo semantics
    (``run_pseudo_labelling.py:887-925``: dataset repo, created up front
    with ``exist_ok=True``, incremental file uploads, final folder upload).

    ``api`` is injectable for tests; by default an ``HfApi`` client is
    constructed (requires ``huggingface_hub`` and network access).
    """

    def __init__(self, repo_id: str, token: Optional[str] = None,
                 private: bool = True, repo_type: str = "dataset",
                 api=None):
        if api is None:
            try:
                from huggingface_hub import HfApi
            except ImportError as e:  # pragma: no cover
                raise RuntimeError(
                    "--push_to_hub requires the huggingface_hub package; "
                    "install it or use --publish_dir for a local mirror"
                ) from e
            api = HfApi(token=token)
        self.api = api
        self.repo_id = repo_id
        self.repo_type = repo_type
        self.api.create_repo(repo_id, repo_type=repo_type, private=private,
                             exist_ok=True)

    def publish(self, out_dir: Path, files: Sequence[Path],
                message: str) -> None:
        out_dir = Path(out_dir)
        for f in files:
            f = Path(f)
            if not f.is_file():
                continue
            self.api.upload_file(
                path_or_fileobj=str(f),
                path_in_repo=str(f.relative_to(out_dir)),
                repo_id=self.repo_id, repo_type=self.repo_type,
                commit_message=message)

    def finalize(self, out_dir: Path, message: str) -> None:
        self.api.upload_folder(
            folder_path=str(out_dir), repo_id=self.repo_id,
            repo_type=self.repo_type, commit_message=message)


class _SafePublisher(Publisher):
    """Wrap a publisher so transient failures are logged, not raised —
    a flaky artifact channel must not kill a multi-day labelling run."""

    def __init__(self, inner: Publisher):
        self.inner = inner
        self.failures = 0

    def publish(self, out_dir, files, message):
        try:
            self.inner.publish(out_dir, files, message)
        except Exception:  # noqa: BLE001 - deliberately broad: keep labelling
            self.failures += 1
            logger.exception("incremental publish failed (%d so far); "
                             "artifacts remain on local disk", self.failures)

    def finalize(self, out_dir, message):
        try:
            self.inner.finalize(out_dir, message)
        except Exception:  # noqa: BLE001
            self.failures += 1
            logger.exception("final publish failed; artifacts remain on "
                             "local disk")


def make_publisher(publish_dir: Optional[str] = None,
                   push_to_hub: Optional[str] = None,
                   hub_token: Optional[str] = None,
                   private: bool = True) -> Optional[Publisher]:
    """Build the configured publisher (or None when publishing is off).

    Both backends may be active at once (mirror locally AND push to the
    Hub); failures in either are contained per-backend.
    """
    backends: list[Publisher] = []
    if publish_dir:
        backends.append(LocalMirrorPublisher(publish_dir))
    if push_to_hub:
        backends.append(HubPublisher(push_to_hub, token=hub_token,
                                     private=private))
    if not backends:
        return None
    if len(backends) == 1:
        return _SafePublisher(backends[0])
    return _SafePublisher(_Fanout(backends))


class _Fanout(Publisher):
    def __init__(self, backends: Iterable[Publisher]):
        self.backends = list(backends)

    def publish(self, out_dir, files, message):
        errs = []
        for b in self.backends:
            try:
                b.publish(out_dir, files, message)
            except Exception as e:  # noqa: BLE001 - isolate backends
                errs.append(e)
        if errs:
            raise errs[0]

    def finalize(self, out_dir, message):
        errs = []
        for b in self.backends:
            try:
                b.finalize(out_dir, message)
            except Exception as e:  # noqa: BLE001
                errs.append(e)
        if errs:
            raise errs[0]
