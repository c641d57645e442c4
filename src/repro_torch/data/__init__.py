from repro_torch.data.pipeline import (
    CurationSpec,
    SketchedDataPipeline,
    make_corpus_metadata,
)
