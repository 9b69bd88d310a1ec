from .activation import ReLU, Sigmoid, Silu, Tanh
from .common import Dropout, Embedding, Linear
from .container import LayerList, Sequential
from .conv import Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D, Conv3DTranspose
from .loss import CrossEntropyLoss
from .norm import BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, LayerNorm, RMSNorm
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D, AvgPool1D,
                      AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D)
from .rnn import (GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell, RNNCellBase, SimpleRNN,
                  SimpleRNNCell)
from .transformer import MultiHeadAttention, TransformerEncoder, TransformerEncoderLayer

__all__ = ["ReLU", "Sigmoid", "Silu", "Tanh", "Dropout", "Embedding", "Linear", "LayerList",
           "Sequential", "Conv1D", "Conv1DTranspose", "Conv2D", "Conv2DTranspose", "Conv3D",
           "Conv3DTranspose", "CrossEntropyLoss", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "LayerNorm", "RMSNorm", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "GRU", "LSTM", "RNN", "BiRNN", "GRUCell", "LSTMCell", "RNNCellBase",
           "SimpleRNN", "SimpleRNNCell", "MultiHeadAttention", "TransformerEncoder",
           "TransformerEncoderLayer"]
