// HierarchyVisualization.tsx (760 LoC): EloSteepness lameness hierarchy —
// quality-metrics banner (steepness/linearity/IRR), category tiles and
// filter, 4 view modes (list / bar / David's / distribution), hover video
// preview, click-through detail modal with Elo-history chart, snapshot
// save modal + saved-snapshot grid, full recalculation.
import {api, h, main, fmt, pct, esc, short, when, toast, USER}
  from "/static/app.js";

// category thresholds per tsx:73-76; confidence per tsx:91-96
const catOf = (elo) => elo > 1550 ? "lame" : elo < 1450 ? "healthy"
  : "intermediate";
const CAT_COLOR = {lame: "var(--bad)", intermediate: "var(--warn)",
                   healthy: "var(--ok)"};
const confOf = (r) => (Math.min(1, (r.total_comparisons || 0) / 20) +
                       (1 - (r.elo_uncertainty ?? 350) / 350)) / 2;
const catChip = (c) => `<span class="badge" style="border:1px solid ${
  CAT_COLOR[c]};color:${CAT_COLOR[c]}">${c}</span>`;

export default async function HierarchyVisualization() {
  const hr = await api("/api/elo/hierarchy");
  const snaps = await api("/api/elo/snapshots")
    .then(r => r.snapshots || []).catch(() => []);
  const ranking = hr.ranking.map(r => ({
    ...r, category: catOf(r.elo_rating ?? 1500), confidence: confOf(r)}));
  const m = hr.metrics || {};
  const privileged = USER && ["admin", "researcher"].includes(USER.role);

  const minElo = Math.min(...ranking.map(r => r.elo_rating), 1400);
  const maxElo = Math.max(...ranking.map(r => r.elo_rating), 1600);
  const eloRange = maxElo - minElo || 1;
  const nCat = (c) => ranking.filter(r => r.category === c).length;

  main.append(h(`<div class="panel"><h2>Lameness hierarchy
      <span class="dim">EloSteepness ranking with David's scores</span>
      ${privileged ? `<button class="mini" id="hv-snap">save snapshot</button>`
        : ""}
      ${USER && USER.role === "admin" ? `<button class="mini" id="hv-recalc"
        style="color:var(--warn)">recalculate</button>` : ""}</h2>
    <div class="grid" style="grid-template-columns:repeat(4,1fr)">
      <div class="panel" style="text-align:center">
        <div class="stat">${fmt(m.steepness ?? hr.steepness, 3)}</div>
        <div class="dim">steepness (SE ${fmt(m.steepness_se ?? hr.steepness_se,
          3)})</div></div>
      <div class="panel" style="text-align:center">
        <div class="stat" style="color:${(m.steepness ?? 0) > 0.7
          ? "var(--ok)" : (m.steepness ?? 0) > 0.4 ? "var(--warn)"
          : "var(--bad)"}">${esc(m.hierarchy_linearity || "—")}</div>
        <div class="dim">hierarchy linearity</div></div>
      <div class="panel" style="text-align:center">
        <div class="stat">${pct(m.inter_rater_agreement
          ?? hr.inter_rater_reliability)}</div>
        <div class="dim">inter-rater agreement</div></div>
      <div class="panel" style="text-align:center">
        <div class="stat">${hr.total_comparisons}</div>
        <div class="dim">total comparisons</div></div></div>
    <div class="dim" style="margin:6px 0;font-size:12px"><b>Steepness</b>
      measures hierarchy linearity (0–1): &gt;0.7 indicates a clear linear
      hierarchy (EloSteepness methodology).</div>
    <div class="row" style="flex-wrap:wrap;margin-top:6px">
      <span class="badge">${ranking.length} videos</span>
      <span class="badge" style="color:var(--bad)">${nCat("lame")} lame</span>
      <span class="badge" style="color:var(--warn)">${nCat("intermediate")}
        intermediate</span>
      <span class="badge" style="color:var(--ok)">${nCat("healthy")} healthy
      </span>
      <span style="flex:1"></span>
      <select id="hv-filter"><option value="all">all categories</option>
        <option value="lame">lame only</option>
        <option value="intermediate">intermediate only</option>
        <option value="healthy">healthy only</option></select>
      <span id="hv-modes"></span></div>
    <div id="hv-view" style="margin-top:10px"></div></div>
    <div id="hv-snaps"></div>
    <div id="hv-modal"></div>`));

  let mode = "bar", filter = "all";
  const modesEl = document.getElementById("hv-modes");
  ["list", "bar", "davids", "distribution"].forEach(mv => {
    // append the BUTTON, not h()'s wrapper div — the active-mode
    // outline below reads children[i].dataset.m
    const b = h(`<button class="mini" data-m="${mv}">${
      mv === "davids" ? "David's" : mv}</button>`).querySelector("button");
    b.onclick = () => { mode = mv; render(); };
    modesEl.append(b);
  });
  document.getElementById("hv-filter").onchange = (e) => {
    filter = e.target.value; render();
  };

  const view = document.getElementById("hv-view");
  const rows = () => filter === "all" ? ranking
    : ranking.filter(r => r.category === filter);

  // hover video preview (tsx:576-597)
  let prev;
  const hoverOn = (el, vid) => {
    el.onmouseenter = () => {
      prev = h(`<div style="position:fixed;z-index:60;width:260px;
          background:var(--panel);border:1px solid var(--line);
          border-radius:8px;overflow:hidden;pointer-events:none">
        <video src="/api/videos/${vid}/stream" autoplay muted loop
          style="width:100%"></video>
        <div class="dim" style="text-align:center;font-size:12px">${
          short(vid, 16)}</div></div>`);
      document.body.append(prev);
      const r = el.getBoundingClientRect();
      prev.style.left = Math.max(10, Math.min(r.left + r.width / 2 - 130,
        window.innerWidth - 280)) + "px";
      prev.style.top = Math.max(10, r.top - 210) + "px";
    };
    el.onmouseleave = () => { if (prev) prev.remove(); prev = null; };
  };

  const render = () => {
    [...modesEl.children].forEach(b =>
      b.style.outline = b.dataset.m === mode ? "2px solid var(--accent)" : "");
    const rs = rows();
    if (!rs.length) {
      view.innerHTML = `<span class="dim">no comparisons yet — rate pairs
        first</span>`;
      return;
    }
    if (mode === "bar") {
      view.innerHTML = `<h3>Elo rating distribution</h3>` + rs.map(r => {
        const w = Math.max(5, 100 * (r.elo_rating - minElo) / eloRange);
        return `<div class="row click-row" data-v="${r.video_id}"
            style="margin-bottom:3px;cursor:pointer">
          <span class="dim" style="width:34px;text-align:right">#${r.rank}
          </span>
          <div class="bar" style="flex:1;height:14px;position:relative">
            <i style="width:${w}%;background:${CAT_COLOR[r.category]};
              opacity:${0.5 + r.confidence * 0.5}"></i>
            <span style="position:absolute;top:0;height:100%;
              background:rgba(0,0,0,.18);left:${Math.max(0,
                w - r.elo_uncertainty / 10)}%;width:${Math.min(100 - w,
                r.elo_uncertainty / 5)}%"></span></div>
          <span style="width:86px;text-align:right;color:${
            CAT_COLOR[r.category]}">${fmt(r.elo_rating, 0)}
            <span class="dim" style="font-size:11px">±${
              fmt(r.elo_uncertainty, 0)}</span></span>
          ${catChip(r.category)}</div>`;
      }).join("") + `<div class="row" style="justify-content:center;
          margin-top:8px;font-size:12px">
        <span><i style="display:inline-block;width:10px;height:10px;
          background:var(--ok)"></i> healthy (&lt;1450)</span>
        <span><i style="display:inline-block;width:10px;height:10px;
          background:var(--warn)"></i> intermediate</span>
        <span><i style="display:inline-block;width:10px;height:10px;
          background:var(--bad)"></i> lame (&gt;1550)</span></div>`;
    } else if (mode === "davids") {
      const sorted = rs.slice().sort((a, b) => b.davids_score - a.davids_score);
      view.innerHTML = `<h3>David's score distribution</h3>
        <div class="dim" style="font-size:12px;margin-bottom:6px">David's
          score accounts for win quality — wins against strong opponents
          count more. 0 = most healthy, 1 = most lame.</div>` +
        sorted.map((r, i) => `<div class="row click-row"
            data-v="${r.video_id}" style="margin-bottom:3px;cursor:pointer">
          <span class="dim" style="width:34px;text-align:right">#${i + 1}
          </span>
          <div class="bar" style="flex:1;height:14px"><i style="width:${
            Math.max(5, 100 * r.davids_score)}%;background:${
            r.davids_score > 0.6 ? "var(--bad)" : r.davids_score < 0.4
            ? "var(--ok)" : "var(--warn)"}"></i></div>
          <span style="width:56px;text-align:right">${
            fmt(r.davids_score, 3)}</span>
          <span class="dim" style="width:84px;text-align:center">${r.wins}W/${
            r.losses}L/${r.ties}T</span></div>`).join("");
    } else if (mode === "distribution") {
      const bins = [
        ["Healthy (<1450)", nCat("healthy"), "var(--ok)"],
        ["Intermediate (1450–1550)", nCat("intermediate"), "var(--warn)"],
        ["Lame (>1550)", nCat("lame"), "var(--bad)"]];
      const maxBin = Math.max(...bins.map(b => b[1]), 1);
      view.innerHTML = `<h3>Category distribution</h3>
        <div class="row" style="align-items:flex-end;justify-content:center;
            gap:36px;height:220px">
        ${bins.map(([l, n, c]) => `<div style="text-align:center">
          <div style="width:80px;background:${c};border-radius:6px 6px 0 0;
            height:${Math.max(6, 180 * n / maxBin)}px"></div>
          <div style="font-size:20px;font-weight:700">${n}</div>
          <div class="dim" style="font-size:11px;max-width:100px">${l}</div>
          </div>`).join("")}</div>`;
    } else {
      view.innerHTML = `<table>
        <tr><th>rank</th><th>video</th><th>elo</th><th>David's</th>
          <th>category</th><th>W/L/T</th><th>confidence</th><th></th></tr>
        ${rs.map(r => `<tr class="click click-row" data-v="${r.video_id}">
          <td>#${r.rank}</td>
          <td class="dim">${short(r.video_id, 12)}</td>
          <td style="color:${CAT_COLOR[r.category]}">${fmt(r.elo_rating, 0)}
            <span class="dim" style="font-size:11px">±${
              fmt(r.elo_uncertainty, 0)}</span></td>
          <td>${fmt(r.davids_score, 3)}</td>
          <td>${catChip(r.category)}</td>
          <td><span class="ok">${r.wins}</span>/<span class="bad">${r.losses}
            </span>/<span class="dim">${r.ties}</span></td>
          <td><div class="row"><div class="bar" style="width:56px">
            <i style="width:${100 * r.confidence}%;background:${
              r.confidence > 0.7 ? "var(--ok)" : r.confidence > 0.4
              ? "var(--warn)" : "var(--bad)"}"></i></div>
            <span class="dim" style="font-size:11px">${
              pct(r.confidence)}</span></div></td>
          <td><button class="mini"
            onclick="event.stopPropagation();go('analysis','${r.video_id}')">
            analysis</button></td></tr>`).join("")}</table>`;
    }
    view.querySelectorAll("[data-v]").forEach(el => {
      el.addEventListener("click", () => openDetail(el.dataset.v));
      hoverOn(el, el.dataset.v);
    });
  };
  render();

  // ---- detail modal (tsx:600-712) ----------------------------------------
  const modal = document.getElementById("hv-modal");
  async function openDetail(vid) {
    if (prev) { prev.remove(); prev = null; }
    const r = ranking.find(x => x.video_id === vid);
    const hist = await api(`/api/elo/history/${vid}`).catch(() => []);
    const last = hist.slice(-30).map(x => x.new_rating ?? x.elo_rating);
    const lo = Math.min(...last, Infinity), hi = Math.max(...last, -Infinity);
    modal.innerHTML = "";
    modal.append(h(`<div style="position:fixed;inset:0;z-index:70;
        background:rgba(0,0,0,.5);display:flex;align-items:center;
        justify-content:center" id="hv-modal-bg">
      <div class="panel" style="max-width:640px;width:92%;max-height:88vh;
          overflow:auto">
        <h2>Video details <span class="dim">${short(vid, 16)}</span>
          <button class="mini" id="hv-close">✕</button></h2>
        <video src="/api/videos/${vid}/stream" controls autoplay muted
          style="width:100%;border-radius:8px"></video>
        ${r ? `<div class="grid" style="grid-template-columns:repeat(5,1fr);
            margin-top:8px">
          <div class="panel" style="text-align:center;padding:8px">
            <div class="stat" style="font-size:20px">#${r.rank}</div>
            <div class="dim" style="font-size:11px">rank</div></div>
          <div class="panel" style="text-align:center;padding:8px">
            <div class="stat" style="font-size:20px;color:${
              CAT_COLOR[r.category]}">${fmt(r.elo_rating, 0)}</div>
            <div class="dim" style="font-size:11px">elo rating</div></div>
          <div class="panel" style="text-align:center;padding:8px">
            <div class="stat" style="font-size:20px">${
              fmt(r.davids_score, 3)}</div>
            <div class="dim" style="font-size:11px">David's score</div></div>
          <div class="panel" style="text-align:center;padding:8px">
            <div class="stat" style="font-size:16px"><span class="ok">${
              r.wins}</span>/<span class="bad">${r.losses}</span>/<span
              class="dim">${r.ties}</span></div>
            <div class="dim" style="font-size:11px">W/L/T</div></div>
          <div class="panel" style="text-align:center;padding:8px">
            <div class="stat" style="font-size:20px">${pct(r.confidence)}
            </div>
            <div class="dim" style="font-size:11px">confidence</div></div>
          </div>` : ""}
        ${last.length > 1 ? `<h3>Elo rating history</h3>
          <div class="row" style="align-items:flex-end;height:90px;gap:2px">
          ${last.map(v => `<div style="flex:1;background:var(--accent);
            border-radius:2px 2px 0 0;height:${Math.max(5,
              100 * (v - lo) / Math.max(hi - lo, 1))}%"
            title="${fmt(v, 0)}"></div>`).join("")}</div>
          <div class="dim" style="text-align:center;font-size:11px">last
            ${last.length} comparisons</div>` : ""}
        <div class="row" style="margin-top:10px">
          <button class="action" style="flex:1" id="hv-full">full analysis
          </button>
          <button class="mini" style="flex:1" id="hv-close2">close</button>
        </div></div></div>`));
    const close = () => modal.innerHTML = "";
    document.getElementById("hv-close").onclick = close;
    document.getElementById("hv-close2").onclick = close;
    document.getElementById("hv-modal-bg").onclick = (e) => {
      if (e.target.id === "hv-modal-bg") close();
    };
    document.getElementById("hv-full").onclick = () => {
      close(); go("analysis", vid);
    };
  }

  // ---- snapshots grid (tsx:556-576) --------------------------------------
  if (snaps.length) {
    document.getElementById("hv-snaps").append(h(`<div class="panel">
      <h2>Saved snapshots (${snaps.length})</h2>
      <div class="grid">${snaps.map(s => `<div class="panel">
        <b>${esc(s.name || s.id)}</b>
        ${s.description ? `<div class="dim" style="font-size:12px">${
          esc(s.description)}</div>` : ""}
        <div class="kv" style="margin-top:4px">
          <span class="dim">videos</span><b>${s.total_videos}</b>
          <span class="dim">comparisons</span><b>${s.total_comparisons}</b>
          <span class="dim">steepness</span><b>${fmt(s.steepness, 3)}</b>
          <span class="dim">IRR</span><b>${pct(s.inter_rater_reliability)}
          </b></div>
        <div class="dim" style="font-size:11px;margin-top:4px">${
          when(s.created_at)}</div></div>`).join("")}</div></div>`));
  }

  // ---- create-snapshot modal (tsx:715-759) -------------------------------
  const snapBtn = document.getElementById("hv-snap");
  if (snapBtn) snapBtn.onclick = () => {
    modal.innerHTML = "";
    modal.append(h(`<div style="position:fixed;inset:0;z-index:70;
        background:rgba(0,0,0,.5);display:flex;align-items:center;
        justify-content:center" id="hv-smodal-bg">
      <div class="panel" style="max-width:420px;width:92%">
        <h2>Create hierarchy snapshot</h2>
        <label class="dim">name</label>
        <input id="hv-sname" placeholder="e.g., Week 1 Assessment"
          style="width:100%;margin-bottom:8px">
        <label class="dim">description (optional)</label>
        <textarea id="hv-sdesc" rows="3" placeholder="Notes about this
snapshot…" style="width:100%"></textarea>
        <div class="row" style="margin-top:10px">
          <button class="action" style="flex:1" id="hv-screate">create
            snapshot</button>
          <button class="mini" style="flex:1" id="hv-scancel">cancel</button>
        </div></div></div>`));
    const close = () => modal.innerHTML = "";
    document.getElementById("hv-scancel").onclick = close;
    document.getElementById("hv-smodal-bg").onclick = (e) => {
      if (e.target.id === "hv-smodal-bg") close();
    };
    document.getElementById("hv-screate").onclick = async () => {
      const name = document.getElementById("hv-sname").value.trim();
      if (!name) return toast("name required", "bad");
      try {
        const r = await api("/api/elo/snapshot", {json: {name,
          description: document.getElementById("hv-sdesc").value.trim()
          || null}});
        toast(`snapshot saved (steepness ${fmt(r.steepness, 3)})`);
        close(); go("hierarchy");
      } catch (e) { toast(e.message, "bad"); }
    };
  };

  const recalc = document.getElementById("hv-recalc");
  if (recalc) recalc.onclick = async () => {
    if (!confirm("This will recalculate all Elo ratings from scratch. " +
                 "Continue?")) return;
    try {
      const r = await api("/api/elo/recalculate", {method: "POST"});
      toast(`replayed ${r.recalculated} comparisons`);
      go("hierarchy");
    } catch (e) { toast(e.message, "bad"); }
  };
}
