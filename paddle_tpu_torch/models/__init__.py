"""Models of the ported slices: Llama (serving and training), ERNIE (MLM
pretraining, sequence classification), PP-OCR det+rec (DBNet, CRNN, OCRSystem) and PP-YOLOE."""
from . import detection, ernie, llama, ocr
from .detection import PPYOLOE, CSPBackbone, CSPBlock, DecoupledHead, PANNeck, ppyoloe_loss
from .ernie import ErnieForMaskedLM, ErnieForSequenceClassification, ErnieModel
from .ocr import CRNN, DBNet, OCRSystem, ctc_greedy_decode, db_loss, db_postprocess

__all__ = ["detection", "ernie", "llama", "ocr", "PPYOLOE", "CSPBackbone", "CSPBlock",
           "DecoupledHead", "PANNeck", "ppyoloe_loss", "ErnieForMaskedLM",
           "ErnieForSequenceClassification", "ErnieModel", "CRNN",
           "DBNet", "OCRSystem", "ctc_greedy_decode", "db_loss", "db_postprocess"]
