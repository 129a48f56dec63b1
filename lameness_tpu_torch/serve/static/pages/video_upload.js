// VideoUpload.tsx (324 LoC): multi-file upload — drag-and-drop zone with
// extension validation, pending queue with per-file label pick
// (lame/sound) + label-all, sequential upload with per-file status and
// progress, post-upload label POST, live pipeline progress over WS.
// Plus the S3-style presigned flow the reference's ingestion service
// exposes.
import {api, h, main, esc, toast, ws} from "/static/app.js";

const OK_EXT = ["mp4", "avi", "mov", "mkv", "webm"];

export default async function VideoUpload() {
  main.append(h(`<div class="panel"><h2>Upload videos</h2>
    <div id="vu-drop" style="border:2px dashed var(--line);border-radius:10px;
        padding:28px;text-align:center;cursor:pointer">
      <div style="font-size:26px">📹</div>
      <div>drag &amp; drop videos here, or click to browse</div>
      <div class="dim" style="font-size:12px">${OK_EXT.join(", ")} —
        each upload runs the full pipeline: preprocess →
        YOLO/SAM/DINO/pose → tracking → predictors → fusion</div>
      <input type="file" id="vu-file" accept="video/*" multiple
        style="display:none"></div>
    <div class="row" style="margin-top:8px" id="vu-actions"
        hidden>
      <button class="mini" id="vu-all-sound">label all sound</button>
      <button class="mini" id="vu-all-lame">label all lame</button>
      <span style="flex:1"></span>
      <button class="action" id="vu-send">upload all</button></div>
    <div id="vu-queue" style="margin-top:8px"></div></div>
  <div class="panel"><h2>Presigned flow (S3-compatible)</h2>
    <div class="row"><input id="s3name" placeholder="filename.mp4">
      <button class="mini" id="s3go">request upload URL</button></div>
    <pre id="s3out" style="display:none"></pre></div>
  <div class="panel"><h2>Pipeline progress</h2>
    <pre id="prog">events appear here while uploads process…</pre></div>`));

  // live pipeline events
  const progress = {};
  const prog = document.getElementById("prog");
  ws("pipeline", (msg) => {
    if (!msg.video_id) return;
    (progress[msg.video_id] = progress[msg.video_id] || []).push(msg.type);
    prog.textContent = Object.entries(progress).map(([v, stages]) =>
      `${v.slice(0, 8)}  ${stages.join(" → ")}`).join("\n");
  });

  // ---- queue state -------------------------------------------------------
  const queue = [];   // {file, label: null|0|1, status, video_id, error}
  const drop = document.getElementById("vu-drop");
  const fileInput = document.getElementById("vu-file");
  const queueEl = document.getElementById("vu-queue");
  const actions = document.getElementById("vu-actions");

  const addFiles = (files) => {
    for (const f of files) {
      const ext = f.name.split(".").pop().toLowerCase();
      if (!OK_EXT.includes(ext)) {
        toast(`${f.name}: unsupported extension .${ext}`, "warn");
        continue;
      }
      queue.push({file: f, label: null, status: "pending",
                  video_id: null, error: null});
    }
    render();
  };

  const STATUS_ICON = {pending: "○", uploading: "⏳", success: "✓",
                       error: "✗"};
  const render = () => {
    actions.hidden = !queue.some(x => x.status === "pending");
    queueEl.innerHTML = "";
    queue.forEach((item, i) => {
      const row = h(`<div class="row" style="margin-bottom:4px">
        <span class="${item.status === "success" ? "ok"
          : item.status === "error" ? "bad" : "dim"}">${
          STATUS_ICON[item.status]}</span>
        <span class="badge">${esc(item.file.name)}</span>
        <span class="dim" style="font-size:11px">${
          (item.file.size / 1048576).toFixed(1)} MB</span>
        ${item.status === "pending" ? `<span>
          <button class="mini" data-l="0">sound</button>
          <button class="mini" data-l="1">lame</button>
          <button class="mini" data-rm="1">remove</button></span>` : ""}
        <span class="dim" id="vu-st-${i}">${item.status === "success"
          ? `video_id <b>${esc(item.video_id)}</b>` : item.error
          ? esc(item.error) : ""}</span>
        ${item.status === "success" ? `<button class="mini"
          data-view="${item.video_id}">results</button>` : ""}</div>`);
      row.querySelectorAll("[data-l]").forEach(b => {
        b.onclick = () => {
          item.label = +b.dataset.l;
          row.querySelectorAll("[data-l]").forEach(x =>
            x.style.outline = +x.dataset.l === item.label
              ? "2px solid var(--accent)" : "");
        };
        if (item.label != null && +b.dataset.l === item.label)
          b.style.outline = "2px solid var(--accent)";
      });
      const rm = row.querySelector("[data-rm]");
      if (rm) rm.onclick = () => { queue.splice(i, 1); render(); };
      const view = row.querySelector("[data-view]");
      if (view) view.onclick = () => go("analysis", view.dataset.view);
      queueEl.append(row);
    });
  };

  drop.onclick = () => fileInput.click();
  fileInput.onchange = () => { addFiles([...fileInput.files]); };
  ["dragenter", "dragover"].forEach(ev => drop.addEventListener(ev, (e) => {
    e.preventDefault(); drop.style.borderColor = "var(--accent)";
  }));
  ["dragleave", "drop"].forEach(ev => drop.addEventListener(ev, (e) => {
    e.preventDefault(); drop.style.borderColor = "var(--line)";
  }));
  drop.addEventListener("drop", (e) => {
    addFiles([...e.dataTransfer.files]);
  });

  document.getElementById("vu-all-sound").onclick = () => {
    queue.forEach(x => { if (x.status === "pending") x.label = 0; });
    render();
  };
  document.getElementById("vu-all-lame").onclick = () => {
    queue.forEach(x => { if (x.status === "pending") x.label = 1; });
    render();
  };

  document.getElementById("vu-send").onclick = async () => {
    const pending = queue.filter(x => x.status === "pending");
    if (!pending.length) return toast("queue is empty", "warn");
    for (const item of pending) {
      item.status = "uploading"; render();
      try {
        const r = await fetch(
          `/api/videos/upload?filename=${
            encodeURIComponent(item.file.name)}`,
          {method: "POST", body: await item.file.arrayBuffer()});
        if (!r.ok) throw new Error((await r.json()).detail || r.statusText);
        const data = await r.json();
        item.video_id = data.video_id;
        item.status = "success";
        if (item.label != null) {
          await api(`/api/videos/${data.video_id}/label`,
                    {json: {label: item.label}}).catch(() => {});
        }
      } catch (e) {
        item.status = "error"; item.error = e.message;
      }
      render();
    }
    const ok = queue.filter(x => x.status === "success").length;
    toast(`${ok}/${queue.length} uploaded — processing in background`);
  };

  document.getElementById("s3go").onclick = async () => {
    const name = document.getElementById("s3name").value || "video.mp4";
    try {
      const r = await api("/api/videos/upload-url",
                          {json: {filename: name}});
      const out = document.getElementById("s3out");
      out.style.display = "";
      out.textContent = JSON.stringify(r, null, 2) +
        "\n\nPUT the bytes to upload_url, then POST " +
        `/api/videos/${r.video_id}/confirm-upload`;
    } catch (e) { toast(e.message, "bad"); }
  };
}
