"""gRPC client stub / servicer glue for the Inference service.

Hand-written equivalent of what ``grpcio-tools`` would generate for
``ml_service.proto`` (the build image ships ``protoc`` but not the Python
gRPC plugin). Method paths, serializers and class names match the generated
form exactly, so config files referencing
``...ml_service_pb2_grpc.add_InferenceServicer_to_server`` keep working.
"""

from __future__ import annotations

import grpc
from google.protobuf import empty_pb2

from . import ml_service_pb2

_SERVICE = "home_native.v1.Inference"


class InferenceStub:
    """Client-side stub."""

    def __init__(self, channel: grpc.Channel):
        self.Infer = channel.stream_stream(
            f"/{_SERVICE}/Infer",
            request_serializer=ml_service_pb2.InferRequest.SerializeToString,
            response_deserializer=ml_service_pb2.InferResponse.FromString,
        )
        self.GetCapabilities = channel.unary_unary(
            f"/{_SERVICE}/GetCapabilities",
            request_serializer=empty_pb2.Empty.SerializeToString,
            response_deserializer=ml_service_pb2.Capability.FromString,
        )
        self.StreamCapabilities = channel.unary_stream(
            f"/{_SERVICE}/StreamCapabilities",
            request_serializer=empty_pb2.Empty.SerializeToString,
            response_deserializer=ml_service_pb2.Capability.FromString,
        )
        self.Health = channel.unary_unary(
            f"/{_SERVICE}/Health",
            request_serializer=empty_pb2.Empty.SerializeToString,
            response_deserializer=empty_pb2.Empty.FromString,
        )


class InferenceServicer:
    """Server-side service skeleton; override the methods you implement."""

    def Infer(self, request_iterator, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        context.set_details("Method not implemented!")
        raise NotImplementedError("Method not implemented!")

    def GetCapabilities(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        context.set_details("Method not implemented!")
        raise NotImplementedError("Method not implemented!")

    def StreamCapabilities(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        context.set_details("Method not implemented!")
        raise NotImplementedError("Method not implemented!")

    def Health(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        context.set_details("Method not implemented!")
        raise NotImplementedError("Method not implemented!")


def add_InferenceServicer_to_server(servicer: InferenceServicer, server: grpc.Server) -> None:
    rpc_method_handlers = {
        "Infer": grpc.stream_stream_rpc_method_handler(
            servicer.Infer,
            request_deserializer=ml_service_pb2.InferRequest.FromString,
            response_serializer=ml_service_pb2.InferResponse.SerializeToString,
        ),
        "GetCapabilities": grpc.unary_unary_rpc_method_handler(
            servicer.GetCapabilities,
            request_deserializer=empty_pb2.Empty.FromString,
            response_serializer=ml_service_pb2.Capability.SerializeToString,
        ),
        "StreamCapabilities": grpc.unary_stream_rpc_method_handler(
            servicer.StreamCapabilities,
            request_deserializer=empty_pb2.Empty.FromString,
            response_serializer=ml_service_pb2.Capability.SerializeToString,
        ),
        "Health": grpc.unary_unary_rpc_method_handler(
            servicer.Health,
            request_deserializer=empty_pb2.Empty.FromString,
            response_serializer=empty_pb2.Empty.SerializeToString,
        ),
    }
    generic_handler = grpc.method_handlers_generic_handler(_SERVICE, rpc_method_handlers)
    server.add_generic_rpc_handlers((generic_handler,))
