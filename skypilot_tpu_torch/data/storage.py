"""The prefix store: where a replica exports its prefix artifacts on a
preemption notice and where a replacement pre-warms from.

Own copy of what skypilot_tpu/data/storage.py's `artifact_store_from_url`
needs: the single-object API (put/get/delete/list) of `GcsStore` (argv
calls of `gcloud storage`, then `gsutil`), of `LocalStore` (a directory
standing in for a `local://` bucket, under the reference's default root)
and of `PlainDirStore` (a bare directory path), `_KeyPrefixStore` for a
subpath, and the URL resolution itself; an unknown scheme raises
StorageSpecError. Nothing of the reference's bucket lifecycle or its
state database.
"""
from __future__ import annotations

import enum
import os
import shutil
import subprocess
from typing import Optional

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch.data import data_utils


class StoreType(enum.Enum):
    """The store kinds a prefix-store URL resolves to."""
    GCS = 'GCS'
    LOCAL = 'LOCAL'


class AbstractStore:
    """One bucket's single-object API (the reference's AbstractStore,
    without the lifecycle the prefix store never calls)."""

    STORE_TYPE: StoreType

    def __init__(self, name: str,
                 source: Optional[str] = None) -> None:
        data_utils.validate_bucket_name(name)
        self.name = name
        self.source = source

    def initialize(self) -> None:
        """Create the bucket if needed."""
        raise NotImplementedError

    def url(self) -> str:
        raise NotImplementedError

    def put_file(self, local_path: str, key: str) -> None:
        """Upload one local file as object `key` in the bucket."""
        raise NotImplementedError

    def get_file(self, key: str, local_path: str) -> None:
        """Download object `key` to `local_path`."""
        raise NotImplementedError

    def list_keys(self, prefix: str = '') -> list:
        """Object keys in the bucket starting with `prefix` (flat —
        no delimiter semantics), sorted ascending."""
        raise NotImplementedError

    def __repr__(self) -> str:
        return f'{type(self).__name__}({self.name!r})'


class GcsStore(AbstractStore):
    """A gs:// bucket through `gcloud storage` (then `gsutil`).

    Commands run as argv lists (no shell), so user-controlled paths and
    bucket names cannot inject shell syntax; when the primary tool fails
    and the fallback also fails, BOTH stderrs are surfaced."""

    STORE_TYPE = StoreType.GCS

    def url(self) -> str:
        return f'gs://{self.name}'

    @staticmethod
    def _run_first_ok(argv_attempts: list, what: str,
                      ok_stderr: Optional[str] = None
                      ) -> 'subprocess.CompletedProcess':
        """Run each argv until one succeeds and return its completed
        process; on total failure raise with every attempt's stderr
        (the old `a 2>/dev/null || b` pattern silently discarded the
        primary tool's diagnostics). A FAILING attempt whose stderr
        contains `ok_stderr` (case-insensitive) is returned as-is —
        the caller treats that outcome as benign (e.g. a listing that
        'matched no objects')."""
        errors = []
        for argv in argv_attempts:
            try:
                proc = subprocess.run(argv, capture_output=True,
                                      text=True, check=False)
            except FileNotFoundError as e:
                errors.append(f'{argv[0]}: {e}')
                continue
            if proc.returncode == 0:
                return proc
            if ok_stderr is not None and \
                    ok_stderr in proc.stderr.lower():
                return proc
            errors.append(f'$ {" ".join(argv)}\n'
                          f'[rc={proc.returncode}] {proc.stderr.strip()}')
        raise exceptions.StorageUploadError(
            f'{what} failed; all attempts:\n' + '\n'.join(errors))

    def initialize(self) -> None:
        try:
            probe = subprocess.run(
                ['gcloud', 'storage', 'buckets', 'describe',
                 f'gs://{self.name}'],
                capture_output=True, text=True, check=False)
            if probe.returncode == 0:
                return
        except FileNotFoundError:
            pass  # no gcloud binary: the create attempt reports it
        self._run_first_ok(
            [['gcloud', 'storage', 'buckets', 'create',
              f'gs://{self.name}']],
            what=f'Creating bucket gs://{self.name}')

    def put_file(self, local_path: str, key: str) -> None:
        self._run_first_ok(
            [['gcloud', 'storage', 'cp', local_path,
              f'gs://{self.name}/{key}'],
             ['gsutil', 'cp', local_path, f'gs://{self.name}/{key}']],
            what=f'Uploading {local_path!r} to gs://{self.name}/{key}')

    def get_file(self, key: str, local_path: str) -> None:
        self._run_first_ok(
            [['gcloud', 'storage', 'cp', f'gs://{self.name}/{key}',
              local_path],
             ['gsutil', 'cp', f'gs://{self.name}/{key}', local_path]],
            what=f'Downloading gs://{self.name}/{key}')

    def delete_key(self, key: str) -> None:
        self._run_first_ok(
            [['gcloud', 'storage', 'rm', f'gs://{self.name}/{key}'],
             ['gsutil', 'rm', f'gs://{self.name}/{key}']],
            what=f'Deleting gs://{self.name}/{key}')

    def list_keys(self, prefix: str = '') -> list:
        # Auth/config/network failures must NOT read as an empty store
        # (they raise from _run_first_ok): a replacement replica that
        # swallowed them here would log a plausible 'no-artifact' cold
        # start and hide the misconfiguration forever. Both tools
        # phrase a genuinely empty listing as 'matched no objects'.
        proc = self._run_first_ok(
            [['gcloud', 'storage', 'ls',
              f'gs://{self.name}/{prefix}*'],
             ['gsutil', 'ls', f'gs://{self.name}/{prefix}*']],
            what=f'Listing gs://{self.name}/{prefix}*',
            ok_stderr='matched no objects')
        if proc.returncode != 0:
            return []
        head = f'gs://{self.name}/'
        return sorted(
            line[len(head):] for line in proc.stdout.splitlines()
            if line.startswith(head) and not line.endswith('/'))


class LocalStore(AbstractStore):
    """A directory pretending to be a bucket: the local:// scheme, with
    GcsStore's object calls over the filesystem."""

    STORE_TYPE = StoreType.LOCAL

    @property
    def bucket_dir(self) -> str:
        return data_utils.fake_bucket_dir(self.name)

    def url(self) -> str:
        return f'local://{self.name}'

    def initialize(self) -> None:
        os.makedirs(self.bucket_dir, exist_ok=True)

    def put_file(self, local_path: str, key: str) -> None:
        dst = os.path.join(self.bucket_dir, key)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        # Copy-to-temp + atomic rename: a reader listing the bucket
        # never sees a half-written object (the prefix-artifact import
        # path relies on "newest listed object is complete").
        tmp = f'{dst}.tmp.{os.getpid()}'
        shutil.copyfile(local_path, tmp)
        os.replace(tmp, dst)

    def get_file(self, key: str, local_path: str) -> None:
        shutil.copyfile(os.path.join(self.bucket_dir, key), local_path)

    def delete_key(self, key: str) -> None:
        try:
            os.remove(os.path.join(self.bucket_dir, key))
        except FileNotFoundError:
            pass

    def list_keys(self, prefix: str = '') -> list:
        if not os.path.isdir(self.bucket_dir):
            return []
        out = []
        for root, _dirs, files in os.walk(self.bucket_dir):
            for fname in files:
                key = os.path.relpath(os.path.join(root, fname),
                                      self.bucket_dir)
                if key.startswith(prefix) and '.tmp.' not in key:
                    out.append(key)
        return sorted(out)


class PlainDirStore(AbstractStore):
    """A bare directory with the single-object store API — the
    serve-replica prefix-artifact backend when the operator points
    `--prefix-store` at a path instead of a bucket URI (one machine /
    NFS; tests use local:// buckets for hermetic isolation instead)."""

    STORE_TYPE = StoreType.LOCAL

    def __init__(self, path: str) -> None:  # pylint: disable=super-init-not-called
        # No bucket-name validation: an arbitrary path IS the store.
        self.name = path
        self.source = None
        self._dir = os.path.expanduser(path)

    @property
    def bucket_dir(self) -> str:
        return self._dir

    def url(self) -> str:
        return self._dir

    def initialize(self) -> None:
        os.makedirs(self._dir, exist_ok=True)

    put_file = LocalStore.put_file
    get_file = LocalStore.get_file
    delete_key = LocalStore.delete_key
    list_keys = LocalStore.list_keys



class _KeyPrefixStore:
    """Single-object store view rooted at an object subpath: every
    put/get/list key is transparently namespaced under it, so
    `gs://bucket/staging/prefixes` and `gs://bucket/prod/prefixes`
    are DISJOINT artifact namespaces on one bucket (dropping the
    subpath silently merged them — a prod replacement could pre-warm
    from a staging export)."""

    def __init__(self, inner: AbstractStore, subpath: str) -> None:
        self._inner = inner
        self._sub = subpath.strip('/')

    def url(self) -> str:
        return f'{self._inner.url()}/{self._sub}'

    def put_file(self, local_path: str, key: str) -> None:
        self._inner.put_file(local_path, f'{self._sub}/{key}')

    def get_file(self, key: str, local_path: str) -> None:
        self._inner.get_file(f'{self._sub}/{key}', local_path)

    def delete_key(self, key: str) -> None:
        self._inner.delete_key(f'{self._sub}/{key}')

    def list_keys(self, prefix: str = '') -> list:
        head = f'{self._sub}/'
        return [k[len(head):]
                for k in self._inner.list_keys(head + prefix)]



def artifact_store_from_url(url: str):
    """Resolve a store URL for single-object artifact traffic (serve
    prefix exports): gs://bucket[/subpath] → GcsStore,
    local://bucket[/subpath] → LocalStore (hermetic fake-bucket dir),
    anything else → a plain directory. A subpath namespaces the keys
    under it. The store is initialized (bucket/dir created)."""
    sub = ''
    if url.startswith(data_utils.GCS_PREFIX):
        bucket, sub = data_utils.split_gcs_path(url)
        store: AbstractStore = GcsStore(bucket, None)
    elif url.startswith(data_utils.LOCAL_PREFIX):
        bucket, sub = data_utils.split_local_bucket_path(url)
        store = LocalStore(bucket, None)
    else:
        if '://' in url:
            # s3://, r2://, a typo'd scheme… silently treating it as
            # a local directory would export artifacts into a literal
            # './s3:/bucket' dir that dies with the VM — every
            # replacement would log a plausible 'no-artifact' cold
            # start and the misconfiguration would never surface.
            raise exceptions.StorageSpecError(
                f'Unsupported prefix-store scheme: {url!r} '
                f'(supported: gs://, local://, or a plain directory '
                f'path)')
        store = PlainDirStore(url)
    store.initialize()
    if sub:
        return _KeyPrefixStore(store, sub)
    return store
