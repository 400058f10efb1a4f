"""URL helpers of the prefix store.

Own copy of the URL parsing in skypilot_tpu/data/data_utils.py that
data/storage.py needs: `gs://` and `local://` paths, the bucket-name
rule, and the directory behind `local://` buckets (the reference's
default root: `$SKYTPU_FAKE_BUCKET_ROOT`, else `fake_buckets` under
`$SKYTPU_HOME`, default `~/.skytpu`).
"""
from __future__ import annotations

import os
import re
from typing import Tuple

from skypilot_tpu_torch import exceptions

GCS_PREFIX = 'gs://'
LOCAL_PREFIX = 'local://'   # fake bucket scheme for hermetic tests


_BUCKET_NAME_RE = re.compile(r'^[a-z0-9][a-z0-9._-]{1,61}[a-z0-9]$')


def split_gcs_path(gcs_path: str) -> Tuple[str, str]:
    """gs://bucket/key/parts → (bucket, key/parts)
    (reference: data_utils.split_gcs_path)."""
    assert gcs_path.startswith(GCS_PREFIX), gcs_path
    rest = gcs_path[len(GCS_PREFIX):]
    bucket, _, key = rest.partition('/')
    return bucket, key



def split_local_bucket_path(path: str) -> Tuple[str, str]:
    assert path.startswith(LOCAL_PREFIX), path
    rest = path[len(LOCAL_PREFIX):]
    bucket, _, key = rest.partition('/')
    return bucket, key



def validate_bucket_name(name: str) -> None:
    """GCS naming rules (the subset that matters)."""
    if not _BUCKET_NAME_RE.match(name):
        raise exceptions.StorageSpecError(
            f'Invalid bucket name {name!r}: must be 3-63 chars of '
            'lowercase letters, digits, -, _, . and start/end '
            'alphanumeric.')



def fake_bucket_root() -> str:
    """Directory that backs local:// buckets (hermetic tests; also a
    convenient offline mode)."""
    root = os.environ.get('SKYTPU_FAKE_BUCKET_ROOT')
    if root:
        return root
    home = os.path.expanduser(os.environ.get('SKYTPU_HOME', '~/.skytpu'))
    return os.path.join(home, 'fake_buckets')


def fake_bucket_dir(bucket: str) -> str:
    return os.path.join(fake_bucket_root(), bucket)

