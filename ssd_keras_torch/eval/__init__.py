from ssd_keras_torch.eval.coco import get_coco_category_maps, predict_all_to_json
from ssd_keras_torch.eval.cocoeval import COCOEvalBBox, coco_bbox_iou
from ssd_keras_torch.eval.evaluator import Evaluator

__all__ = ["Evaluator", "get_coco_category_maps", "predict_all_to_json", "COCOEvalBBox",
           "coco_bbox_iou"]
