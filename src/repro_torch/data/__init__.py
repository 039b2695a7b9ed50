from repro_torch.data.synthetic import (image_member_datasets,
                                        lm_member_datasets, sample_batch,
                                        sample_relabel_subset, take_rows)

__all__ = ["image_member_datasets", "lm_member_datasets", "sample_batch",
           "sample_relabel_subset", "take_rows"]
