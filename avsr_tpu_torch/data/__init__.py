"""Data: datasets, the loader, manifests, media I/O and tokenizers (the
names ``avsr_tpu.data`` re-exports)."""

from avsr_tpu_torch.data.dataset import (  # noqa: F401
    ManifestAVSRDataset,
    Sample,
    SyntheticAVSRDataset,
    build_dataset,
)
from avsr_tpu_torch.data.loader import DataLoader, HostBatch, collate, featurize  # noqa: F401
from avsr_tpu_torch.data.manifest import (  # noqa: F401
    ManifestEntry,
    load_labels,
    load_manifest,
    utt_aliases,
    write_manifest,
)
from avsr_tpu_torch.data.tokenizer import ByteTokenizer, HFTokenizer, load_tokenizer  # noqa: F401
